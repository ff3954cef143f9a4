"""Read-only file-like over a memoryview.

Lets an SDK that reads file objects stream a zero-copy staged buffer
without materialising a ``bytes`` copy of it (the GCS plugin's uploads).
A copy of ``torchsnapshot_tpu/memoryview_stream.py``.
"""

from __future__ import annotations

import io
from typing import Optional


class MemoryviewStream(io.RawIOBase):
    def __init__(self, mv: memoryview) -> None:
        self._mv = mv.cast("B") if mv.format != "B" else mv
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            new_pos = pos
        elif whence == io.SEEK_CUR:
            new_pos = self._pos + pos
        elif whence == io.SEEK_END:
            new_pos = len(self._mv) + pos
        else:
            raise ValueError(f"invalid whence: {whence}")
        if new_pos < 0:
            raise ValueError(f"negative seek position: {new_pos}")
        self._pos = new_pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: Optional[int] = -1) -> bytes:
        if size is None or size < 0:
            end = len(self._mv)
        else:
            end = min(self._pos + size, len(self._mv))
        data = bytes(self._mv[self._pos : end])
        self._pos = end
        return data

    def readinto(self, b) -> int:
        end = min(self._pos + len(b), len(self._mv))
        n = end - self._pos
        b[:n] = self._mv[self._pos : end]
        self._pos = end
        return n

    def close(self) -> None:
        self._mv = memoryview(b"")
        super().close()
