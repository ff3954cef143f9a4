"""A multi-process launcher for multi-rank runs on one host.

A port of ``run_with_processes`` of ``torchsnapshot_tpu/test_utils.py``.
:func:`run_with_processes` spawns ``nproc`` real processes, each running
``fn(rank, world_size, *args)``. The calling process hosts a
:class:`TCPStore` and every rank installs a :class:`Coordinator` over it as
its default (and sees ``LOCAL_WORLD_SIZE``, as under torchrun); with
``process_group=True`` the calling process hosts a c10d
store instead, on which the ranks form a gloo process group, and that store
carries the coordination (:class:`C10dStore`). Spawned workers re-import
the caller's module, so a script that calls this needs an
``if __name__ == "__main__":`` guard, and ``fn`` must be a module-level
function.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, Dict, List, Optional


def _worker_entry(
    fn: Callable[..., Any],
    rank: int,
    world_size: int,
    store_port: Optional[int],
    c10d_port: Optional[int],
    error_queue: "mp.Queue",
    args: tuple,
) -> None:
    import os

    from .parallel import coordinator as coordinator_mod
    from .parallel.store import TCPStore

    # The ranks share this host's disk, as torchrun would report.
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    try:
        if c10d_port is not None:
            import torch.distributed as dist

            c10d = dist.TCPStore("127.0.0.1", c10d_port, is_master=False)
            dist.init_process_group("gloo", store=c10d, rank=rank, world_size=world_size)
        else:
            coordinator_mod.set_coordinator(
                coordinator_mod.Coordinator(
                    TCPStore("127.0.0.1", store_port, is_server=False), rank, world_size
                )
            )
        fn(rank, world_size, *args)
        error_queue.put((rank, None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        error_queue.put((rank, traceback.format_exc()))
        raise
    finally:
        if c10d_port is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def run_with_processes(
    fn: Callable[..., Any],
    nproc: int,
    args: tuple = (),
    timeout_s: float = 120.0,
    process_group: bool = False,
) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``nproc`` spawned processes.
    Raises ``RuntimeError`` naming every rank that failed or died, and
    ``TimeoutError`` when a rank has not reported within ``timeout_s``;
    every process is reaped on every exit path."""
    from .parallel.store import TCPStore

    # The servers live here, on ports the OS picked and this process holds
    # for the whole run: no rank can lose a server under it, and no other
    # job can take the port between choosing and binding it.
    store = c10d = None
    if process_group:
        import torch.distributed as dist

        c10d = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    else:
        store = TCPStore("127.0.0.1", 0, is_server=True)
    ctx = mp.get_context("spawn")
    error_queue: mp.Queue = ctx.Queue()
    procs: List[mp.Process] = []
    for rank in range(nproc):
        p = ctx.Process(
            target=_worker_entry,
            args=(
                fn,
                rank,
                nproc,
                None if store is None else store.port,
                None if c10d is None else c10d.port,
                error_queue,
                args,
            ),
            daemon=False,
        )
        p.start()
        procs.append(p)
    failures: Dict[int, str] = {}
    reported: set = set()
    # A worker killed outright never reports: "dead and nothing queued" on
    # two consecutive polls is its report.
    dead_strikes: Dict[int, int] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(reported) < nproc:
            try:
                rank, err = error_queue.get(timeout=0.2)
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r in reported or p.is_alive():
                        continue
                    dead_strikes[r] = dead_strikes.get(r, 0) + 1
                    if dead_strikes[r] >= 2:
                        reported.add(r)
                        failures[r] = f"died without reporting (exitcode {p.exitcode})"
                if time.monotonic() > deadline:
                    pending = sorted(set(range(nproc)) - reported)
                    raise TimeoutError(
                        f"ranks {pending} neither reported nor exited within {timeout_s}s"
                    )
                continue
            reported.add(rank)
            dead_strikes.clear()
            if err is not None:
                failures[rank] = err
            else:
                failures.pop(rank, None)
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.is_alive():
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if store is not None:
            store.shutdown()
    if failures:
        msgs = "\n".join(f"--- rank {r} ---\n{e}" for r, e in sorted(failures.items()))
        raise RuntimeError(f"{len(failures)}/{nproc} workers failed:\n{msgs}")
