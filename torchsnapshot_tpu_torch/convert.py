"""Bit-exact conversion between numpy trees and torch tensor trees.

The JAX package's state, fetched to the host (``jax.device_get``), is a
tree of numpy arrays whose dtypes may come from ml_dtypes (bfloat16, the
float8 types). numpy has no such dtypes of its own and torch cannot read
them, so both directions go through integer views of the same width:
bf16 through ``uint16``, fp8 through ``uint8``. Values never pass through a
wider float. Containers (dict, list, tuple) are rebuilt; other leaves pass
through unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# Extension dtypes by name -> (torch dtype, same-width integer view).
_EXT = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, np.uint8),
    "float8_e5m2fnuz": (torch.float8_e5m2fnuz, np.uint8),
    "float8_e8m0fnu": (torch.float8_e8m0fnu, np.uint8),
}
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.uint16}
_EXT_BY_TORCH = {t: (name, view) for name, (t, view) in _EXT.items()}


def _map(tree: Any, leaf) -> Any:
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, leaf)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf) for v in tree)
    return leaf(tree)


def _array_to_tensor(a: Any, device: Any) -> Any:
    if not isinstance(a, np.ndarray):
        return a
    # copy(order="C"), not ascontiguousarray: the latter makes 0-dim 1-dim.
    a = a.copy(order="C")
    ext = _EXT.get(a.dtype.name)
    if ext is not None:
        t = torch.from_numpy(a.view(ext[1])).view(ext[0])
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tensor_to_array(t: Any) -> Any:
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach().cpu().contiguous()
    ext = _EXT_BY_TORCH.get(t.dtype)
    if ext is None:
        return t.numpy().copy()
    import ml_dtypes

    raw = t.view(_INT_OF_WIDTH[t.element_size()]).numpy().copy()
    return raw.view(np.dtype(getattr(ml_dtypes, ext[0])))


def from_numpy_tree(tree: Any, device: Any = "cpu") -> Any:
    """numpy (and ml_dtypes) arrays -> torch tensors on ``device``."""
    return _map(tree, lambda a: _array_to_tensor(a, device))


def to_numpy_tree(tree: Any) -> Any:
    """torch tensors -> numpy arrays (ml_dtypes for bf16 and fp8)."""
    return _map(tree, _tensor_to_array)
