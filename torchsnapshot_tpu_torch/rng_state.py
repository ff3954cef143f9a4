"""Host and device RNG capture.

``Snapshot`` treats ``RNGState`` specially: the state a restore reinstates
is the state as of the *beginning* of the take, and taking a snapshot does
not advance any generator. Captured: Python's ``random``, NumPy's global
generator, torch's CPU generator and, when CUDA is initialised, every CUDA
device's generator.
"""

from __future__ import annotations

import random
from typing import Any, Dict

import numpy as np
import torch


class RNGState:
    def state_dict(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "python": random.getstate(),
            "numpy": np.random.get_state(),
            "torch": torch.get_rng_state(),
        }
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            state["cuda"] = torch.cuda.get_rng_state_all()
        return state

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        random.setstate(state_dict["python"])
        np.random.set_state(state_dict["numpy"])
        torch.set_rng_state(state_dict["torch"].cpu())
        if "cuda" in state_dict:
            torch.cuda.set_rng_state_all([s.cpu() for s in state_dict["cuda"]])
