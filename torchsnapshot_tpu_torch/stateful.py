"""The app-state protocol.

Anything with ``state_dict()``/``load_state_dict()`` is checkpointable:
``torch.nn.Module``, ``torch.optim.Optimizer``, :class:`StateDict` and user
classes all qualify by duck type, without inheriting anything.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable


@runtime_checkable
class Stateful(Protocol):
    def state_dict(self) -> Dict[str, Any]:
        ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        ...


AppState = Dict[str, Stateful]
