"""The control and the planted faults of the check that decides ``correct``.
The benchmark's own runs run neither.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3
    python3 portbench/control.py --workload <cell> --seeds 1 2 3 --fault altered --seconds 5

Without ``--fault``: the control. For each seed the cell's set-up runs
(the state made from the seed, the warm-up, the reference copy), then the
plain reference, passed through the next precision below the state's
(``reference.compare.lower_precision``), stands in for what the program
would restore, and is compared as a run compares the program's output.
Each seed prints its ``leaves_differing`` and ``bytes_differing``; the
control has to read above the limits (0), so that a run whose program
stored the state at a lower precision comes out not correct.

With ``--fault``: whole runs of the cell (``--seconds`` long), with the
timed path broken underneath by one of :data:`FAULTS`, each of which has
to come out ``correct: false``. ``portbench/tests/test_portbench_correct.py``
runs both at toy sizes on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
from typing import Callable, Dict, Iterator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _patched(owner: object, name: str, make: Callable[[Callable], Callable]) -> Iterator[None]:
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _payload(path: str) -> bool:
    """An object holding state bytes (not metadata, sidecars or telemetry)."""
    return not os.path.basename(path).startswith(".") and "/.telemetry/" not in f"/{path}"


def _flip(data: bytes) -> bytes:
    if not data:
        return data
    b = bytearray(data)
    b[len(b) // 2] ^= 0x01
    return bytes(b)


@contextlib.contextmanager
def altered() -> Iterator[None]:
    """A stored byte altered where it is produced: every payload object the
    memory plugin stores has one bit flipped."""
    from torchsnapshot_tpu_torch.storage_plugins import memory

    def write(orig):
        async def patched(self, write_io):
            await orig(self, write_io)
            if _payload(write_io.path):
                self.objects[write_io.path] = _flip(self.objects[write_io.path])

        return patched

    def commit(orig):
        async def patched(self):
            path = self._path
            await orig(self)
            if _payload(path):
                self._plugin.objects[path] = _flip(self._plugin.objects[path])

        return patched

    with _patched(memory.MemoryStoragePlugin, "write", write), _patched(memory._MemoryWriteStream, "commit", commit):
        yield


@contextlib.contextmanager
def unchanged() -> Iterator[None]:
    """A restore that returns with the state unchanged."""
    from torchsnapshot_tpu_torch import snapshot

    with _patched(snapshot.Snapshot, "restore", lambda orig: lambda self, *a, **k: None):
        yield


@contextlib.contextmanager
def half() -> Iterator[None]:
    """Half of every payload read left out: its second half reads as zeros."""
    from torchsnapshot_tpu_torch.storage_plugins import memory

    def read(orig):
        async def patched(self, read_io):
            await orig(self, read_io)
            if _payload(read_io.path):
                view = memoryview(read_io.buf).cast("B")
                if read_io.buf is read_io.into:
                    view[len(view) // 2 :] = bytes(len(view) - len(view) // 2)
                else:
                    read_io.buf = bytes(view[: len(view) // 2]) + bytes(len(view) - len(view) // 2)

        return patched

    with _patched(memory.MemoryStoragePlugin, "read", read):
        yield


FAULTS: Dict[str, Callable[[], contextlib.AbstractContextManager]] = {
    "altered": altered,
    "unchanged": unchanged,
    "half": half,
}


def control_reading(cell: str, seed: int, device: str = "cuda", config=None, traffic=None) -> Dict[str, int]:
    """The cell's set-up from ``seed``, then the reference at the next
    precision below in the program's place, compared as a run compares."""
    import torch

    from portbench.lib import cells
    from portbench.lib.workload import CellRunner, Run
    from portbench.reference.compare import lower_precision

    bench = cells.load_benchmark()
    w = cells.workload(bench, cell)
    run = Run(cell, config or cells.config(w["config"]), traffic or cells.traffic(w["traffic"]), False)
    runner = CellRunner(run, seed, torch.device(device))
    try:
        runner.set_up()
        # The reference of the state as set-up leaves it (an async cell's
        # warm-up step has moved it on since its copy).
        named, scalars = runner.state.named(), runner.state.scalars()
        runner.reference.refresh(named, scalars)
        return runner.reference.compare(lower_precision(named), scalars)
    finally:
        runner.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != os.path.dirname(os.path.abspath(__file__))]
    sys.path.insert(0, ROOT)
    from portbench import run as run_mod
    from portbench.lib import cells

    bench = cells.load_benchmark()
    run_mod.prepare_environment()
    import torch

    from portbench.lib import harness

    for seed in args.seeds:
        if args.fault is None:
            reading = control_reading(args.workload, seed)
        else:
            with FAULTS[args.fault]():
                out = harness.run_cell(args.workload, seed, args.seconds, False, bench=bench)
            line = harness.result_line(out, 1, torch.cuda.get_device_name(0))
            reading = {"correct": line["correct"], "failed": line["failed"], **out["checks"]}
        print(json.dumps({"cell": args.workload, "seed": seed, "fault": args.fault or "control", **reading}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
