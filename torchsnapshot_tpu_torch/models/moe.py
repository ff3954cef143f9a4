"""Mixture-of-Experts workload: expert-parallel (EP) sharded state.

A port of ``torchsnapshot_tpu/models/moe.py``: a top-1-gated expert FFN
with the experts stacked on dim 0 of ``w_up`` ``(experts, d_model, d_ff)``
and ``w_down`` ``(experts, d_ff, d_model)``, so an EP state is a DTensor
whose dim 0 is sharded over the mesh's ``"ep"`` axis. Checkpoint-wise it
is the generic sharded path; saving at one EP degree and restoring at
another is the elasticity story for scaling the expert count.

As in the JAX package, dispatch is dense (every token is evaluated against
every expert and masked by its one-hot top-1 gate), the gate is an
``nn.Linear`` without bias whose parameters stay fp32 and which computes
in the promoted dtype of its input and weight, and the experts are bf16
(the JAX package creates them in its input's dtype, bf16 in
``init_params``). The ``argmax`` routing flips on rounding in bf16, so
parity with the JAX layer is held in fp32 (``module.float()``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import _lecun_, placements_of, shard_module


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 128
    d_ff: int = 512
    n_experts: int = 8


class MoELayer(nn.Module):
    """Top-1-gated expert FFN with experts stacked on dim 0."""

    def __init__(self, cfg: MoEConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.gate = nn.Linear(cfg.d_model, cfg.n_experts, bias=False, dtype=torch.float32)
        self.w_up = nn.Parameter(torch.empty(cfg.n_experts, cfg.d_model, cfg.d_ff, dtype=torch.bfloat16))
        self.w_down = nn.Parameter(torch.empty(cfg.n_experts, cfg.d_ff, cfg.d_model, dtype=torch.bfloat16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.gate.weight
        dt = torch.promote_types(x.dtype, w.dtype)
        gate = F.linear(x.to(dt), w.to(dt))
        # Hard top-1 routing: the gate gets no gradient through this layer
        # (a checkpoint workload, not a trainable router).
        onehot = F.one_hot(gate.argmax(-1), self.cfg.n_experts).to(x.dtype)
        h = F.relu(torch.einsum("bsd,edf->bsef", x, self.w_up))
        y = torch.einsum("bsef,efd->bsed", h, self.w_down)
        return torch.einsum("bsed,bse->bsd", y, onehot)


@torch.no_grad()
def init_params(cfg: MoEConfig, seed: int = 0, device: Any = "cuda") -> MoELayer:
    """A :class:`MoELayer` on ``device`` with LeCun-normal weights drawn from
    a ``torch.Generator`` seeded with ``seed``."""
    device = torch.device(device)
    with torch.device("meta"):
        model = MoELayer(cfg)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    # flax's fan_in: the gate kernel's input dim (dim 1 of the nn.Linear
    # weight); experts x input dim for an (experts, in, out) stack.
    _lecun_(model.gate.weight, cfg.d_model, gen)
    _lecun_(model.w_up, cfg.n_experts * cfg.d_model, gen)
    _lecun_(model.w_down, cfg.n_experts * cfg.d_ff, gen)
    return model


def ep_spec(name: str, shape: Sequence[int], mesh: Any) -> List[Any]:
    """EP rule as placements: the expert-stacked weights shard dim 0 over
    ``"ep"``; the gate is replicated."""
    if "w_up" in name or "w_down" in name:
        return placements_of(("ep", None, None), mesh)
    return placements_of((), mesh)


def shard_params_ep(module: MoELayer, mesh: Any) -> MoELayer:
    """Turn ``module``'s parameters into DTensors over ``mesh`` (which must
    have an ``"ep"`` dim) under the EP rule."""
    return shard_module(module, mesh, ep_spec)

