"""Shipped test utilities, the port of ``torchsnapshot_tpu/test_utils.py``.

- :func:`check_state_dict_eq` and :func:`assert_state_dict_eq` compare
  nested state dicts whose leaves may be tensors (CPU or CUDA), DTensors
  (through their full tensor, a collective), numpy arrays or plain values;
  exact mode compares bytes, so NaN payloads count.
- :func:`rand_array` makes a random tensor of any dtype of the snapshot
  format that torch holds, byte-equal to the JAX package's ``rand_array``
  for the same seed.
- :func:`run_with_processes`, a multi-process launcher for multi-rank
  runs on one host.

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

import numpy as np
import torch

from .serialization import BYTE_VIEW_DTYPES, dtype_to_string, string_to_dtype, tensor_as_bytes


def _as_tensor(x: Any) -> Any:
    """An array leaf as a CPU tensor (a DTensor as its full tensor, a
    numpy array or scalar through ``convert``'s bit-exact views); a numpy
    array with no raw form stays a numpy array; None for other leaves."""
    from .convert import _array_to_tensor
    from .io_preparer import is_dtensor

    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (np.ndarray, np.generic)):
        return _array_to_tensor(np.asarray(x), torch.device("cpu"))
    return None


def _leaf_eq(a: Any, b: Any, exact: bool) -> bool:
    a_t, b_t = _as_tensor(a), _as_tensor(b)
    if (a_t is None) != (b_t is None):
        return False
    if a_t is None:
        return bool(a == b)
    if isinstance(a_t, np.ndarray) or isinstance(b_t, np.ndarray):
        return isinstance(a_t, np.ndarray) and isinstance(b_t, np.ndarray) and bool(np.array_equal(a_t, b_t))
    if a_t.dtype != b_t.dtype or a_t.shape != b_t.shape:
        return False
    if exact:
        return torch.equal(tensor_as_bytes(a_t), tensor_as_bytes(b_t))
    wide = torch.complex128 if a_t.is_complex() else torch.float64
    return bool(torch.allclose(a_t.to(wide), b_t.to(wide)))


def check_state_dict_eq(a: Any, b: Any, exact: bool = True) -> bool:
    """Whether nested dicts, lists and tuples ``a`` and ``b`` hold the same
    keys, lengths and leaves. Array leaves must agree in dtype and shape,
    and in bytes (``exact``) or within ``allclose`` in float64 (NaNs then
    never agree)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a.keys()) != set(b.keys()):
            return False
        return all(check_state_dict_eq(a[k], b[k], exact) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        return all(check_state_dict_eq(x, y, exact) for x, y in zip(a, b))
    return _leaf_eq(a, b, exact)


def assert_state_dict_eq(tc_or_a: Any, a: Any = None, b: Any = None, exact: bool = True) -> None:
    """``assert_state_dict_eq(a, b)`` or ``assert_state_dict_eq(test_case,
    a, b)``: raises ``AssertionError`` unless :func:`check_state_dict_eq`."""
    if b is None:
        a, b = tc_or_a, a
    if not check_state_dict_eq(a, b, exact):
        raise AssertionError(f"State dicts differ:\n  a={a!r}\n  b={b!r}")


def rand_array(shape: Any, dtype: Any, seed: Optional[int] = None, device: Any = None) -> torch.Tensor:
    """A random tensor of ``dtype`` (a snapshot dtype string, or a torch
    dtype) on ``device``: the current CUDA device unless given, as
    ``convert.from_numpy_tree``. For the same seed its bytes are the JAX
    package's ``rand_array``'s: the same numpy draws, cast with
    ml_dtypes' rounding. A dtype torch lacks raises ``TypeError``."""
    from .convert import target_device

    device = target_device("cuda" if device is None else device)
    name = dtype if isinstance(dtype, str) else dtype_to_string(dtype)
    if name in BYTE_VIEW_DTYPES:
        raise TypeError(f"torch has no dtype {name}; the port restores such entries as uint8 bytes")
    tdtype = string_to_dtype(name)
    rng = np.random.default_rng(seed)
    if name == "bool":
        arr = rng.integers(0, 2, size=shape).astype(np.bool_)
    elif name.startswith(("int", "uint")):
        # The full byte width, sign bit included.
        info = np.iinfo(name)
        wide = np.int64 if name.startswith("int") else np.uint64
        arr = rng.integers(int(info.min), int(info.max), size=shape, dtype=wide).astype(name)
    elif name.startswith("complex"):
        arr = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(name)
    elif name in ("float16", "float32", "float64"):
        # numpy's own casts: torch rounds float64 to float16 through float32.
        arr = rng.standard_normal(shape).astype(name)
    else:
        # bf16 and fp8 round from float64 in torch as in ml_dtypes, except
        # that ml_dtypes gives float8_e8m0fnu's NaN for negative values.
        wide = torch.from_numpy(rng.standard_normal(shape))
        out = wide.to(tdtype)
        if tdtype == torch.float8_e8m0fnu:
            out.view(torch.uint8)[wide < 0] = 0xFF
        return out.to(device)
    return torch.from_numpy(arr).to(device)


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
