"""Pickle preparer for arbitrary objects.

Objects are pickled at staging time, which always runs before
``async_take`` returns (never deferred), so a later mutation cannot reach
the snapshot. Restore materialises a fresh object and hands it to a
callback.
"""

from __future__ import annotations

import asyncio
import pickle
from concurrent.futures import Executor
from typing import Any, Callable, List, Optional, Tuple

from ..io_types import BufferConsumer, BufferStager, BufferType, ReadReq, WriteReq
from ..manifest import ObjectEntry
from ..serialization import Serializer

# Unknown until pickled: a nominal staging/consuming cost.
_NOMINAL_COST = 1024 * 1024


class ObjectBufferStager(BufferStager):
    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def rebind(self, obj: Any) -> None:
        self.obj = obj

    def unbind(self) -> None:
        self.obj = None

    async def stage_buffer(self, executor: Optional[Executor] = None) -> BufferType:
        def dump() -> bytes:
            return pickle.dumps(self.obj, protocol=pickle.HIGHEST_PROTOCOL)

        if executor is None:
            return dump()
        return await asyncio.get_running_loop().run_in_executor(executor, dump)

    def get_staging_cost_bytes(self) -> int:
        return _NOMINAL_COST


class ObjectBufferConsumer(BufferConsumer):
    def __init__(self, callback: Callable[[Any], None]) -> None:
        self._callback = callback

    def set_consume_callback(self, callback: Callable[[Any], None]) -> None:
        self._callback = callback

    async def consume_buffer(
        self, buf: BufferType, executor: Optional[Executor] = None
    ) -> None:
        self._callback(pickle.loads(bytes(buf)))

    def get_consuming_cost_bytes(self) -> int:
        return _NOMINAL_COST


class ObjectIOPreparer:
    @staticmethod
    def prepare_write(
        storage_path: str, obj: Any, replicated: bool = False
    ) -> Tuple[ObjectEntry, List[WriteReq]]:
        entry = ObjectEntry(
            location=storage_path,
            serializer=Serializer.PICKLE,
            obj_type=type(obj).__qualname__,
            replicated=replicated,
        )
        return entry, [WriteReq(path=storage_path, buffer_stager=ObjectBufferStager(obj))]

    @staticmethod
    def prepare_read(
        entry: ObjectEntry, callback: Callable[[Any], None]
    ) -> List[ReadReq]:
        return [ReadReq(path=entry.location, buffer_consumer=ObjectBufferConsumer(callback))]
