"""Bit-exact conversion between numpy trees and torch tensor trees.

The JAX package's state, fetched to the host (``jax.device_get``), is a
tree of numpy arrays whose dtypes may come from ml_dtypes (bfloat16, the
float8 types). numpy has no such dtypes of its own and torch cannot read
them, so both directions go through integer views of the same width:
bf16 through ``uint16``, fp8 through ``uint8``. Values never pass through a
wider float. Containers (dict, list, tuple) are rebuilt; other leaves, and numpy
arrays of a dtype with no raw form (both packages pickle those), pass
through unchanged.

Sharded state crosses as a global array: :func:`dtensor_from_numpy` cuts a
rank's local shard out of a global numpy array by the placements' own
geometry (``torch.chunk`` sizes; ``_StridedShard`` under a later ``Shard``
of its dim, as FSDP2 over TP gives it, included) and wraps it as that
rank's DTensor. A
sharded ``jax.Array``, gathered to the host, is such a global array;
:func:`dtensor_from_tensor` does the same from a global torch tensor.

Model weights cross between the JAX package's flax parameter trees and
the port's ``state_dict`` names (:func:`transformer_params_from_jax`,
:func:`moe_params_from_jax` and their inverses), bit-exact per element.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from .d2h import require_cuda
from .io_preparers.sharded_array import contiguous_stride, placement_offsets_sizes
from .serialization import numpy_dtype_to_string

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
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a namedtuple
        return type(tree)(*(_map(v, leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf) for v in tree)
    return leaf(tree)


def _array_to_tensor(a: Any, device: Any) -> Any:
    if not isinstance(a, np.ndarray):
        return a
    if a.dtype.name not in _EXT and numpy_dtype_to_string(a.dtype) is None:
        return a  # no raw form (``<U3``, ``object``): both packages pickle it
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


def from_numpy_tree(tree: Any, device: Any = "cuda") -> Any:
    """numpy (and ml_dtypes) arrays -> torch tensors on ``device``: the
    current CUDA device by default, like every entry point of the port;
    pass ``device="cpu"`` for the CPU. A CUDA request on a host without
    CUDA raises (``d2h.require_cuda``) rather than return CPU tensors."""
    device = require_cuda(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _map(tree, lambda a: _array_to_tensor(a, device))


def to_numpy_tree(tree: Any) -> Any:
    """torch tensors -> numpy arrays (ml_dtypes for bf16 and fp8)."""
    return _map(tree, _tensor_to_array)


def local_shard_of(
    global_array: np.ndarray,
    mesh_shape: Sequence[int],
    placements: Sequence[Any],
    coordinate: Sequence[int],
) -> np.ndarray:
    """The block of ``global_array`` that mesh ``coordinate`` holds (one
    rectangle; ``NotImplementedError`` for placements that leave several,
    such as a lone ``_StridedShard``)."""
    offsets, sizes = placement_offsets_sizes(global_array.shape, mesh_shape, placements, coordinate)
    index = tuple(slice(o, o + n) for o, n in zip(offsets, sizes))
    return global_array[index] if index else global_array


def dtensor_from_numpy(global_array: np.ndarray, device_mesh: Any, placements: Sequence[Any]) -> Any:
    """This rank's DTensor of ``global_array`` over ``device_mesh`` with
    ``placements``: its local shard (bit-exact, on the mesh's device type)
    wrapped by ``DTensor.from_local`` without a collective."""
    coordinate = device_mesh.get_coordinate()
    local = local_shard_of(global_array, device_mesh.shape, placements, coordinate)
    device = torch.device(device_mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return _wrap_local(_array_to_tensor(local, device), device_mesh, placements, global_array.shape)


def dtensor_from_tensor(global_tensor: torch.Tensor, device_mesh: Any, placements: Sequence[Any]) -> Any:
    """This rank's DTensor of ``global_tensor`` (the same value on every
    rank, on the mesh's device) over ``device_mesh`` with ``placements``: a
    private copy of its local shard, without a collective."""
    coordinate = device_mesh.get_coordinate()
    local = local_shard_of(global_tensor, device_mesh.shape, placements, coordinate)
    return _wrap_local(
        local.clone(memory_format=torch.contiguous_format),
        device_mesh,
        placements,
        global_tensor.shape,
    )


def _wrap_local(local: torch.Tensor, device_mesh: Any, placements: Sequence[Any], shape: Sequence[int]) -> Any:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local,
        device_mesh,
        list(placements),
        run_check=False,
        shape=torch.Size(shape),
        stride=contiguous_stride(shape),
    )


# ---------------------------------------------------------------------------
# Model weights: flax parameter trees <-> the port's state_dict
# ---------------------------------------------------------------------------

# Modules whose torch weight is an ``nn.Linear`` weight ``(out, in)``: the
# transpose of flax's ``(in, out)`` kernel. Every other weight keeps
# flax's layout (embeddings, ``DenseGeneral`` kernels, stacked experts).
_LINEAR_MODULES = frozenset({"up", "down", "lm_head", "gate"})
# flax leaf name -> torch leaf name.
_TORCH_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _flax_leaf_name(module: str, leaf: str) -> str:
    if leaf != "weight":
        return leaf
    if module.startswith("ln"):
        return "scale"
    if module.endswith("embed"):
        return "embedding"
    return "kernel"


def _params_from_jax(params: Any) -> Dict[str, torch.Tensor]:
    """A flax parameter tree of numpy (and ml_dtypes) arrays, as
    ``jax.device_get`` returns it, to the port module's ``state_dict``
    (CPU tensors; ``module.load_state_dict`` copies them in)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, parts: tuple) -> None:
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(v, parts + (str(k),))
            return
        module = parts[-2] if len(parts) > 1 else ""
        t = _array_to_tensor(np.asarray(node), "cpu")
        if module in _LINEAR_MODULES and parts[-1] == "kernel":
            t = t.t().contiguous()
        out[".".join(parts[:-1] + (_TORCH_LEAF.get(parts[-1], parts[-1]),))] = t

    walk(params, ())
    return out


def _params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`_params_from_jax`: a port ``state_dict`` to the
    JAX package's nested parameter dict of numpy arrays."""
    out: Dict[str, Any] = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        module = parts[-2] if len(parts) > 1 else ""
        leaf = _flax_leaf_name(module, parts[-1])
        t = t.detach()
        if module in _LINEAR_MODULES and leaf == "kernel":
            t = t.t()
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = _tensor_to_array(t)
    return out


# The transformer's and the MoE layer's trees share one naming scheme.
transformer_params_from_jax = moe_params_from_jax = _params_from_jax
transformer_params_to_jax = moe_params_to_jax = _params_to_jax
