"""The yardstick's arithmetic: the chip's peaks, the parameter and FLOP
counts of the trainer, byte bounds and shares of a peak. Pure Python,
checked against hand-worked values in ``tests/test_portbench_arith.py``.
"""

from __future__ import annotations

from typing import Dict

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
# rates, at the full 700 W power limit).
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def param_counts(vocab: int, d_model: int, n_layers: int, d_ff: int, max_pos: int) -> Dict[str, int]:
    """Parameters of the trainer (``lib/trainer.py``) by part: the token
    and position embeddings, one block (fused qkv and proj with biases,
    up and down with biases, two LayerNorms), the final LayerNorm and the
    untied head with its bias."""
    block = (
        2 * d_model  # ln1
        + d_model * 3 * d_model + 3 * d_model  # qkv
        + d_model * d_model + d_model  # proj
        + 2 * d_model  # ln2
        + d_model * d_ff + d_ff  # up
        + d_ff * d_model + d_model  # down
    )
    out = {
        "embed": vocab * d_model,
        "pos_embed": max_pos * d_model,
        "block": block,
        "blocks": n_layers * block,
        "ln_f": 2 * d_model,
        "head": vocab * d_model + vocab,
    }
    out["total"] = out["embed"] + out["pos_embed"] + out["blocks"] + out["ln_f"] + out["head"]
    # What the matmuls touch: everything but the two lookup tables.
    out["non_embedding"] = out["total"] - out["embed"] - out["pos_embed"]
    return out


def layernorm_params(d_model: int, n_layers: int) -> int:
    """Parameters held in fp32 (the LayerNorms: two per block and the
    final one, scale and bias each)."""
    return (2 * n_layers + 1) * 2 * d_model


def train_flops_per_token(non_embedding_params: int, n_layers: int, d_model: int, seq: int) -> int:
    """Model FLOPs of one trained token (forward and backward):
    ``6 N + 12 L d s``, with ``N`` the non-embedding weights and the head
    and ``s`` the positions attended over."""
    return 6 * non_embedding_params + 12 * n_layers * d_model * seq


def copy_bound_s(nbytes: int) -> float:
    """Least time for a device copy of ``nbytes``: read once, written once,
    at the HBM rate (``chip_smoke._bound_ms`` at commit 69d9a1f, in s)."""
    return 2 * nbytes / H100_HBM_BYTES_PER_S


def share_pct(least_s: float, took_s: float) -> float:
    """``least_s`` as a percentage of ``took_s``: a roofline share."""
    return 100.0 * least_s / took_s


def mfu_pct(flops: float, seconds: float, peak_flops: float = H100_BF16_FLOPS) -> float:
    """Model FLOPs over ``seconds`` as a percentage of the bf16 peak."""
    return 100.0 * flops / (seconds * peak_flops)
