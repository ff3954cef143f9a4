"""torchsnapshot_tpu_torch — the PyTorch/CUDA port of torchsnapshot_tpu.

Checkpoints ``torch`` state (``nn.Module``, ``optim.Optimizer``,
:class:`StateDict` and any other object with ``state_dict``/
``load_state_dict``) in the same on-disk format as the JAX package, so a
snapshot written by either restores through the other. CUDA tensors are
staged through explicit CUDA streams and two hand-written kernels
(``kernels.py``): K1 packs small tensors into one slab, K2 forks the state
for ``async_take``.
"""

from .rng_state import RNGState
from .snapshot import PendingSnapshot, Snapshot
from .state_dict import StateDict
from .stateful import AppState, Stateful
from .version import __version__

__all__ = [
    "Snapshot",
    "PendingSnapshot",
    "Stateful",
    "StateDict",
    "RNGState",
    "AppState",
    "__version__",
]
