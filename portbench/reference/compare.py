"""The plain reference that decides ``correct``: a copy of the state's
bytes taken by torch alone, and a byte-for-byte comparison with what the
program restored.

Nothing here imports the port, and nothing takes what the port made: the
copy is taken from the trainer's own tensors at the instant the program
is asked to capture them, and the comparison reads the program's output
(the live tensors a restore filled) only to judge it. The copy lives in
host memory, so the device's memory peak holds none of it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Named = Sequence[Tuple[str, torch.Tensor]]


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


# Host chunks of the copy: a power of two, which torch's pinned-memory
# allocator does not round up.
_CHUNK_BYTES = 1 << 30


class StateCopy:
    """Every leaf's bytes, held on the host: leaves packed first-fit, the
    largest first, into chunks of ``_CHUNK_BYTES`` (a larger leaf in a
    chunk of its own), pinned where a leaf lives on a card, so that the
    copy takes no device memory; and the scalars as they are."""

    def __init__(self, named: Named, scalars: Dict[str, int]) -> None:
        self.names = [n for n, _ in named]
        self.meta = {n: (t.dtype, tuple(t.shape)) for n, t in named}
        pin = any(t.device.type == "cuda" for _, t in named)
        sizes: List[int] = []
        self.where: Dict[str, Tuple[int, int, int]] = {}  # name -> (chunk, begin, end)
        for n, t in sorted(named, key=lambda nt: -nt[1].numel() * nt[1].element_size()):
            nbytes = t.numel() * t.element_size()
            i = next((i for i, used in enumerate(sizes) if used + nbytes <= _CHUNK_BYTES), len(sizes))
            if i == len(sizes):
                sizes.append(0)
            self.where[n] = (i, sizes[i], sizes[i] + nbytes)
            sizes[i] += nbytes
        self.chunks = [torch.empty(max(size, _CHUNK_BYTES) if pin else size, dtype=torch.uint8, pin_memory=pin) for size in sizes]
        self.scalars: Dict[str, int] = {}
        self.refresh(named, scalars)

    def _host(self, name: str) -> torch.Tensor:
        chunk, lo, hi = self.where[name]
        return self.chunks[chunk][lo:hi]

    def refresh(self, named: Named, scalars: Dict[str, int]) -> None:
        """Take the copy anew from ``named`` (the same leaves)."""
        if [n for n, _ in named] != self.names:
            raise ValueError("the state holds other leaves than the copy")
        for n, t in named:
            self._host(n).copy_(_bytes_of(t), non_blocking=True)
        for device in {t.device for _, t in named if t.device.type == "cuda"}:
            torch.cuda.synchronize(device)
        self.scalars = dict(scalars)

    def compare(self, named: Named, scalars: Dict[str, int]) -> Dict[str, int]:
        """How far ``named`` and ``scalars`` (the program's output) are from
        the copy: ``leaves_differing`` (leaves whose dtype, shape or any
        byte differs, missing leaves and differing scalars included) and
        ``bytes_differing`` (bytes that differ in leaves of the same size).
        Both are 0 for a bit-exact restore. Each leaf is compared where it
        lives, the copy's bytes brought there one leaf at a time."""
        got = dict(named)
        leaves, nbytes = 0, 0
        for n in self.names:
            t = got.get(n)
            if t is None:
                leaves += 1
                continue
            a = _bytes_of(t)
            b = self._host(n)
            if (t.dtype, tuple(t.shape)) != self.meta[n] or a.numel() != b.numel():
                leaves += 1
                continue
            diff = int((a != b.to(a.device)).sum())
            nbytes += diff
            leaves += diff > 0
        leaves += len(set(got) - set(self.names))
        leaves += sum(scalars.get(k) != v for k, v in self.scalars.items())
        return {"leaves_differing": leaves, "bytes_differing": nbytes}


@torch.no_grad()
def lower_precision(named: Named) -> List[Tuple[str, torch.Tensor]]:
    """The control: each leaf passed through the next precision below its
    own (bfloat16 and float16 through float8 e4m3, float32 through
    bfloat16, float64 through float32) and back; other dtypes as they are."""
    below = {
        torch.bfloat16: torch.float8_e4m3fn,
        torch.float16: torch.float8_e4m3fn,
        torch.float32: torch.bfloat16,
        torch.float64: torch.float32,
    }
    out = []
    for n, t in named:
        low = below.get(t.dtype)
        out.append((n, t.detach().to(low).to(t.dtype) if low is not None else t.detach().clone()))
    return out
