"""StateDict — a dict that is its own Stateful.

The idiomatic way to checkpoint values not owned by a model or optimizer::

    progress = StateDict(current_epoch=0, global_step=0)
    app_state = {"model": model, "progress": progress}
"""

from __future__ import annotations

from typing import Any, Dict


class StateDict(dict):
    def state_dict(self) -> Dict[str, Any]:
        return self

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.clear()
        self.update(state_dict)
