"""The trainer whose state the benchmark checkpoints: a frozen copy.

Copied at commit 69d9a1f0f1cf5e9726c8dfadc9a8c27c1e078152 from
``torchsnapshot_tpu_torch/models/transformer.py`` (``TransformerConfig``,
``LayerNorm``, ``DenseGeneral``, ``Block``, ``Transformer``, ``loss_fn``)
and ``torchsnapshot_tpu_torch/dryrun.py`` (``adamw``, ``tokens_for_step``,
``train_step``, ``train_state_tensors``), so that a later change to the
port's model cannot move the yardstick. The sharding rules are left out.

Changes from the copy, each to follow OPT (arXiv:2205.01068, §2.2 and
§2.4) where the configuration states it:

- :func:`init_model` draws every weight from one device generator in a few
  large calls (a flat normal buffer per dtype, sliced and scaled per leaf)
  instead of one truncated normal per leaf. The standard deviations are
  the copied initialisers' (``1/sqrt(d_model)`` for the embeddings, LeCun
  ``1/sqrt(fan_in)`` for the projections, zero biases, unit LayerNorm
  scales); the truncation is dropped.
- The block's activation is OPT's ReLU (the copy's was a tanh GELU), and
  its residual dropout comes from the configuration (OPT: 0.1, after the
  attention's projection and after the feed-forward block).
- The head computes in the parameters' dtype (the copy cast it to fp32);
  the loss is taken in fp32.
- :class:`AdamW` keeps its moments in fp32 whatever the parameters' dtype,
  as OPT kept its Adam state (the copy used ``torch.optim.AdamW``, whose
  moments take the parameters' dtype).

This module imports nothing of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


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
    dropout: float = 0.0

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
        x = x + self._dropout(self.proj(attn))
        up = F.relu(self.up(self.ln2(x)))
        return x + self._dropout(self.down(up))

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.dropout
        return F.dropout(x, p) if p and self.training else x


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
        return self.lm_head(self.ln_f(x))


def _init_std(cfg: TransformerConfig, name: str) -> float:
    """The copied initialisers' standard deviation of weight ``name``."""
    if "embed" in name:
        return 1.0 / math.sqrt(cfg.d_model)
    if ".down." in name:
        return 1.0 / math.sqrt(cfg.d_ff)
    return 1.0 / math.sqrt(cfg.d_model)  # qkv, proj (fan_in n_heads * head_dim), up, lm_head


# Elements drawn per generator call: large calls, a bounded temporary.
_DRAW_ELEMS = 1 << 29


@torch.no_grad()
def init_model(cfg: TransformerConfig, seed: int, device: Any) -> Transformer:
    """A :class:`Transformer` on ``device`` whose weights come from one
    ``torch.Generator`` on ``device`` seeded with ``seed``: normal draws in
    calls of ``_DRAW_ELEMS`` elements, in the parameter dtype, each leaf a
    scaled slice. LayerNorm scales are 1, biases 0."""
    device = torch.device(device)
    with torch.device("meta"):
        model = Transformer(cfg)
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn: List[Tuple[str, torch.Tensor]] = []
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            drawn.append((name, p))
    buf = torch.empty(0, dtype=cfg.param_dtype, device=device)
    used = 0
    left = sum(p.numel() for _, p in drawn)
    for name, p in drawn:
        n = p.numel()
        while n > 0:
            if used == buf.numel():
                buf = torch.randn(min(left, _DRAW_ELEMS), generator=gen, dtype=cfg.param_dtype, device=device)
                left -= buf.numel()
                used = 0
            take = min(n, buf.numel() - used)
            start = p.numel() - n
            p.view(-1)[start : start + take].copy_(buf[used : used + take]).mul_(_init_std(cfg, name))
            used += take
            n -= take
    return model


def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy (fp32) of ``tokens`` ``(batch, seq)``."""
    logits = model(tokens[:, :-1])
    targets = tokens[:, 1:]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1))


# Elements of one group of leaves that AdamW updates together: its fp32
# temporaries stay under a few GB.
_ADAM_GROUP_ELEMS = 1 << 28


class AdamW(torch.optim.Optimizer):
    """AdamW (decoupled weight decay) with fp32 moments for parameters of
    any dtype: per leaf ``step`` (a host fp32 tensor, as
    ``torch.optim.AdamW`` keeps it), ``exp_avg`` and ``exp_avg_sq``. The
    update is taken in fp32 and rounded once into the parameter. Leaves go
    through ``torch._foreach_*`` calls in groups of ``_ADAM_GROUP_ELEMS``
    elements."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """torch's, but the loaded moments keep their fp32 tensors: torch
        casts every floating state tensor to its parameter's dtype."""
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        for p, i in zip(params, ids):
            for key, v in state_dict["state"].get(i, {}).items():
                if key != "step" and isinstance(v, torch.Tensor):
                    self.state[p][key] = v.to(device=p.device)

    def _state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, (b1, b2), eps, wd = group["lr"], group["betas"], group["eps"], group["weight_decay"]
            live = [p for p in group["params"] if p.grad is not None]
            batch: List[torch.Tensor] = []
            size = 0
            for p in live + [None]:
                if p is not None:
                    batch.append(p)
                    size += p.numel()
                if batch and (p is None or size >= _ADAM_GROUP_ELEMS):
                    self._update(batch, lr, b1, b2, eps, wd)
                    batch, size = [], 0

    def _update(self, params: List[torch.Tensor], lr: float, b1: float, b2: float, eps: float, wd: float) -> None:
        states = [self._state(p) for p in params]
        for st in states:
            st["step"] += 1
        t = float(states[0]["step"])
        m = [st["exp_avg"] for st in states]
        v = [st["exp_avg_sq"] for st in states]
        g = [p.grad.float() for p in params]
        torch._foreach_lerp_(m, g, 1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, math.sqrt(1 - b2**t))
        torch._foreach_add_(denom, eps)
        # fp32 leaves update in place; the others through an fp32 copy.
        p32 = [p.float() for p in params]
        torch._foreach_mul_(p32, 1 - lr * wd)
        torch._foreach_addcdiv_(p32, m, denom, value=-lr / (1 - b1**t))
        for p, q in zip(params, p32):
            if q is not p:
                p.copy_(q)


def adamw(params) -> AdamW:
    """AdamW with optax's ``adamw(1e-3)`` defaults (torch's default weight
    decay is 0.01, optax's 1e-4) and fp32 moments."""
    return AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def tokens_for_step(
    cfg: TransformerConfig, step: int, batch: int, seed: int, device: Any
) -> torch.Tensor:
    """The ``(batch, max_seq_len + 1)`` tokens of training step ``step``,
    from a ``torch.Generator`` on ``device`` seeded by ``seed`` and the step,
    so a resumed run sees the same tokens."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    shape = (batch, cfg.max_seq_len + 1)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=device)


def train_step(model: Transformer, optimizer: torch.optim.Optimizer, tokens: torch.Tensor) -> torch.Tensor:
    """One step: the loss, its backward, ``optimizer.step()``; returns the
    loss (detached)."""
    loss = loss_fn(model, tokens)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def train_state_tensors(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> List[Tuple[str, torch.Tensor]]:
    """(label, tensor) of every parameter and every optimizer state tensor,
    in a fixed order."""
    out = [(name, p) for name, p in model.named_parameters()]
    for name, p in model.named_parameters():
        for key, v in sorted(optimizer.state.get(p, {}).items()):
            if isinstance(v, torch.Tensor):
                out.append((f"{name}/{key}", v))
    return out
