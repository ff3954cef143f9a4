"""The flagship workload: a decoder-only transformer as an ``nn.Module``,
with TP/FSDP sharding rules over a ``("dp", "tp")`` device mesh.

A port of ``torchsnapshot_tpu/models/transformer.py``. The names and the
structure are the JAX package's (``embed``, ``pos_embed``, ``block_<i>``
with ``ln1``, ``qkv``, ``proj``, ``ln2``, ``up``, ``down``, then ``ln_f``
and ``lm_head``), and so is the arithmetic:

- pre-LN blocks; LayerNorm with ``eps=1e-6``, fp32 parameters and
  statistics, output in the compute dtype (flax's ``LayerNorm``);
- ``qkv`` and ``proj`` keep flax's ``DenseGeneral`` layouts,
  ``(d_model, 3, n_heads, head_dim)`` and ``(n_heads, head_dim, d_model)``,
  so the TP rule shards the head dim as the JAX rule does;
- ``up``, ``down`` and ``lm_head`` are ``nn.Linear``: their weights are the
  transposes of flax's ``(in, out)`` kernels (``convert.py`` maps them);
- the causal mask fills with the compute dtype's most negative value and
  the softmax runs in fp32, cast back;
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- ``lm_head`` computes in fp32 from its parameters.

Weights are drawn from an explicit ``torch.Generator`` with flax's
initialisers' distributions (truncated-normal LeCun kernels, normal
embeddings with std ``1/sqrt(d_model)``, zero biases, unit LayerNorm
scales); they are not the JAX package's values, which ``convert.py``
carries across when a test needs them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a normal truncated to two standard deviations,
# rescaled so the truncated variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 512
    dtype: torch.dtype = torch.bfloat16  # activation/computation dtype
    param_dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class LayerNorm(nn.LayerNorm):
    """flax's ``LayerNorm``: fp32 parameters and statistics, ``eps=1e-6``,
    output in ``dtype``."""

    def __init__(self, d_model: int, dtype: torch.dtype) -> None:
        super().__init__(d_model, eps=1e-6, dtype=torch.float32)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(
            self.out_dtype
        )


class DenseGeneral(nn.Module):
    """A projection with flax's ``DenseGeneral`` layout: ``weight`` has the
    contracted dims first and the feature dims last, ``bias`` the feature
    dims."""

    def __init__(self, in_shape: Sequence[int], features: Sequence[int], dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*in_shape, *features, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(*features, dtype=dtype))
        self.n_in = len(in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.dim() - self.n_in]
        k_in = math.prod(self.weight.shape[: self.n_in])
        y = x.reshape(-1, k_in) @ self.weight.reshape(k_in, -1)
        return y.reshape(*lead, *self.bias.shape) + self.bias


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype)
        self.qkv = DenseGeneral((cfg.d_model,), (3, cfg.n_heads, cfg.head_dim), pd)
        self.proj = DenseGeneral((cfg.n_heads, cfg.head_dim), (cfg.d_model,), pd)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype)
        self.up = nn.Linear(cfg.d_model, cfg.d_ff, dtype=pd)
        self.down = nn.Linear(cfg.d_ff, cfg.d_model, dtype=pd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        qkv = self.qkv(self.ln1(x))
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        scale = 1.0 / math.sqrt(cfg.head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        seq = x.shape[1]
        mask = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(dt).min)
        probs = torch.softmax(logits.float(), dim=-1).to(dt)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + self.proj(attn)
        up = self.up(self.ln2(x))
        return x + self.down(F.gelu(up, approximate="tanh"))


class Transformer(nn.Module):
    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=pd)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.d_model, dtype=pd)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        # Tied-free output head.
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, dtype=pd)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens).to(dt) + self.pos_embed(pos)[None].to(dt)
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_f(x)
        w = self.lm_head
        return F.linear(x.float(), w.weight.float(), w.bias.float())


def _lecun_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    full = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(full, std=std, a=-2 * std, b=2 * std, generator=gen)
    t.copy_(full)


@torch.no_grad()
def init_params(cfg: TransformerConfig, seed: int = 0, device: Any = "cuda") -> Transformer:
    """A :class:`Transformer` on ``device`` with weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    device = torch.device(device)
    with torch.device("meta"):
        model = Transformer(cfg)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if "embed" in name:
            full = torch.empty(p.shape, dtype=torch.float32, device=device)
            full.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
            p.copy_(full)
        elif isinstance(model.get_submodule(name.rsplit(".", 1)[0]), LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif ".proj." in name:
            _lecun_(p, cfg.d_model, gen)  # fan_in = n_heads * head_dim
        elif ".down." in name:
            _lecun_(p, cfg.d_ff, gen)
        else:  # qkv, up, lm_head: fan_in = d_model
            _lecun_(p, cfg.d_model, gen)
    return model


def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (fp32) of ``tokens`` ``(batch, seq)``."""
    logits = model(tokens[:, :-1])
    targets = tokens[:, 1:]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


# ---------------------------------------------------------------------------
# Sharding rules: Megatron-style TP + FSDP over a (dp, tp) mesh
# ---------------------------------------------------------------------------


def param_dims(name: str, fsdp: bool = True) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dim of parameter ``name`` (the JAX package's
    ``PartitionSpec``, in this module's layouts: an ``nn.Linear`` weight is
    the transpose of flax's kernel, so its two axes swap).

    The TP axis shards the contraction-adjacent dims (qkv heads, MLP hidden,
    vocab); the dp axis FSDP-shards the other large dim."""
    dp = "dp" if fsdp else None
    if "qkv.weight" in name:  # (d_model, 3, heads, head_dim)
        return (dp, None, "tp", None)
    if "proj.weight" in name:  # (heads, head_dim, d_model)
        return ("tp", None, dp)
    if "up.weight" in name:  # (d_ff, d_model)
        return ("tp", dp)
    if "down.weight" in name:  # (d_model, d_ff)
        return (dp, "tp")
    if "pos_embed.weight" in name:  # must precede the embed match below
        return (dp, None)
    if "embed.weight" in name:  # (vocab, d_model)
        return (dp, "tp")
    if "lm_head.weight" in name:  # (vocab, d_model)
        return ("tp", dp)
    return ()  # layer norms, biases: replicated


def fit_dims(
    dims: Sequence[Optional[str]], shape: Sequence[int], mesh: Any
) -> Tuple[Optional[str], ...]:
    """``dims`` with every axis dropped (the dim replicated) that its mesh
    axis does not divide, or that the mesh does not have."""
    names = tuple(mesh.mesh_dim_names or ())
    fitted = []
    for d, axis in enumerate(dims):
        if axis is None or d >= len(shape) or axis not in names:
            fitted.append(None)
            continue
        size = int(mesh.shape[names.index(axis)])
        fitted.append(axis if shape[d] % size == 0 else None)
    return tuple(fitted)


def placements_of(dims: Sequence[Optional[str]], mesh: Any) -> List[Any]:
    """DTensor placements, one per mesh dim, of a tensor whose dim ``d`` is
    sharded over mesh axis ``dims[d]``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    placements: List[Any] = [Replicate()] * mesh.ndim
    for d, axis in enumerate(dims):
        if axis is not None:
            placements[names.index(axis)] = Shard(d)
    return placements


def param_spec(name: str, shape: Sequence[int], mesh: Any, fsdp: bool = True) -> List[Any]:
    """Placements of parameter ``name`` of ``shape`` over ``mesh`` (mesh
    dims named ``"dp"`` and ``"tp"``) under the TP/FSDP rule, replicating a
    dim its mesh axis does not divide."""
    return placements_of(fit_dims(param_dims(name, fsdp), shape, mesh), mesh)


def shard_module(module: nn.Module, mesh: Any, spec) -> nn.Module:
    """Replace every parameter of ``module`` (the same full value on every
    rank) by a DTensor parameter over ``mesh`` with placements
    ``spec(name, shape, mesh)``; each rank keeps its own block. No
    collective runs."""
    from ..convert import dtensor_from_tensor

    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        dt = dtensor_from_tensor(p.detach(), mesh, spec(name, tuple(p.shape), mesh))
        setattr(owner, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def shard_params(module: Transformer, mesh: Any, fsdp: bool = True) -> Transformer:
    """Turn ``module``'s parameters into DTensors under the TP/FSDP rule."""
    return shard_module(module, mesh, lambda n, s, m: param_spec(n, s, m, fsdp=fsdp))


def parallelize_fsdp_tp(module: Transformer, mesh: Any) -> Transformer:
    """FSDP2 over TP, as a PyTorch LLM trainer lays its model out on a
    ``("dp", "tp")`` mesh: ``parallelize_module`` over ``mesh["tp"]`` with
    ``ColwiseParallel`` on ``up`` and ``lm_head`` and ``RowwiseParallel`` on
    ``down``, then ``fully_shard`` over ``mesh["dp"]`` on each block and on
    the root. The column-parallel weights come out
    ``(_StridedShard(0, sf=tp), Shard(0))`` over the whole mesh (FSDP's
    rows of each TP block), ``down`` ``(Shard(0), Shard(1))``; every other
    parameter (``DenseGeneral``, embeddings, norms) takes ``fully_shard``
    alone, ``Shard(0)`` over ``mesh["dp"]``. Every rank passes the same
    full weights and keeps its own block of them (``src_data_rank=None``):
    no collective runs, so the layout builds on gloo with CUDA tensors,
    which has no scatter."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    plan: dict = {"lm_head": ColwiseParallel()}
    for i in range(module.cfg.n_layers):
        plan[f"block_{i}.up"] = ColwiseParallel()
        plan[f"block_{i}.down"] = RowwiseParallel()
    parallelize_module(module, mesh["tp"], plan, src_data_rank=None)
    for i in range(module.cfg.n_layers):
        fully_shard(getattr(module, f"block_{i}"), mesh=mesh["dp"])
    fully_shard(module, mesh=mesh["dp"])
    return module
