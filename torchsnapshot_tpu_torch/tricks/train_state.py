"""Stateful adapters for pytrees of torch state, and a fresh optimizer's
state made restorable.

A port of ``torchsnapshot_tpu/tricks/train_state.py`` over
``torch.utils._pytree``:

- :class:`PyTreeStateful` wraps a mutable holder (:class:`Box`) of any
  pytree (nested dicts, lists, tuples, namedtuples of tensors).
  ``state_dict()`` mirrors the tree as nested dicts keyed by path
  components, and ``load_state_dict`` rebuilds the identical tree with the
  restored leaves. The path components are the JAX package's: a dict key
  is its key, a sequence index is its index, an attribute is its name. So a
  snapshot of a nested dict taken through either package's
  ``PyTreeStateful`` has the same logical paths and restores through the
  other.
- :func:`train_state_stateful` is the one-liner for the common case.
- :func:`init_optimizer_state` is the counterpart of optax's ``tx.init``:
  torch optimizers create their state lazily at the first ``step()``, so a
  fresh optimizer has nothing for a restore to fill. Materialising it first
  gives the restore live targets: filled in place on the card, and
  DTensors for DTensor parameters (without them the restore would build
  plain tensors of the global shape, which the next step cannot use).

Usage::

    holder = Box({"params": params, "opt": opt_state})
    app_state = {"train_state": PyTreeStateful(holder), "rng": RNGState()}
    Snapshot.take(path, app_state)
    ...
    Snapshot(path).restore(app_state)   # holder.value is the restored state
"""

from __future__ import annotations

from typing import Any, Dict, Generic, TypeVar

import torch
from torch.utils import _pytree as pytree

T = TypeVar("T")


class Box(Generic[T]):
    """A mutable cell: restore replaces the value (its tensors are filled in
    place where they match)."""

    def __init__(self, value: T) -> None:
        self.value = value


def _path_str(path) -> str:
    return "/".join(_path_parts(path))


def _path_parts(path) -> list:
    return [_key_part(p) for p in path] or ["value"]


def _key_part(p) -> str:
    if isinstance(p, pytree.MappingKey):
        return str(p.key)
    if isinstance(p, pytree.SequenceKey):
        return str(p.idx)
    if isinstance(p, pytree.GetAttrKey):
        return p.name
    return str(p)


class PyTreeStateful:
    """Checkpoint any pytree through a :class:`Box` holder.

    ``state_dict()`` mirrors the pytree as *nested* dicts keyed by path
    components, so snapshot logical paths stay natural —
    ``read_object("0/train_state/params/dense/kernel")`` works."""

    def __init__(self, holder: Box) -> None:
        self._holder = holder

    def state_dict(self) -> Dict[str, Any]:
        nested: Dict[str, Any] = {}
        for path, leaf in pytree.tree_flatten_with_path(self._holder.value)[0]:
            parts = _path_parts(path)
            node = nested
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = leaf
        return nested

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        paths_and_leaves, treedef = pytree.tree_flatten_with_path(self._holder.value)
        new_leaves = []
        for path, _ in paths_and_leaves:
            parts = _path_parts(path)
            node: Any = state_dict
            for part in parts:
                if not isinstance(node, dict) or part not in node:
                    raise KeyError(
                        f"Snapshot is missing pytree leaf {'/'.join(parts)!r}; "
                        f"available top-level keys: {sorted(state_dict)[:10]}"
                    )
                node = node[part]
            new_leaves.append(node)
        self._holder.value = pytree.tree_unflatten(new_leaves, treedef)


def train_state_stateful(holder: Box) -> PyTreeStateful:
    """Adapter for a training state held as a pytree."""
    return PyTreeStateful(holder)


@torch.no_grad()
def init_optimizer_state(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Create the state a fresh ``torch.optim.Adam`` or ``AdamW`` would
    create at its first ``step()``, for every parameter that has none yet:
    ``step`` (a CPU fp32 scalar, on the parameter's device when
    ``capturable`` or ``fused``), ``exp_avg``, ``exp_avg_sq`` (and
    ``max_exp_avg_sq`` with ``amsgrad``) as zeros like the parameter, a
    DTensor for a DTensor parameter. No parameter changes, and a later
    ``step()`` proceeds as from a fresh optimizer."""
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(
            f"init_optimizer_state supports torch.optim.Adam and AdamW, not {type(optimizer).__name__}"
        )
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for group in optimizer.param_groups:
        moments = ["exp_avg", "exp_avg_sq"] + (["max_exp_avg_sq"] if group["amsgrad"] else [])
        for p in group["params"]:
            if not p.requires_grad or optimizer.state.get(p):
                continue
            state = optimizer.state[p]
            if group["capturable"] or group["fused"]:
                dtype = torch.float32 if group["fused"] else scalar
                state["step"] = torch.zeros((), dtype=dtype, device=p.device)
            else:
                state["step"] = torch.tensor(0.0, dtype=scalar, device="cpu")
            for name in moments:
                state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return optimizer
