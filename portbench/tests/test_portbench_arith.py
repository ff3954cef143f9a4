"""The yardstick's arithmetic against hand-worked values of the two
configurations, and the trainer built on the meta device against it."""

import pytest
import torch

from portbench.lib import arith, cells
from portbench.lib.state import model_config
from portbench.lib.trainer import Transformer

OPT = dict(vocab=50272, d_model=4096, d_ff=16384, max_pos=2048)


def test_stage_parameters():
    c = arith.param_counts(n_layers=8, **OPT)
    # 205,914,112 + 8,388,608 + 8 x 201,379,840 + 8,192 + 205,964,384
    assert c["block"] == 201_379_840
    assert c["total"] == 2_031_314_016
    assert c["non_embedding"] == 1_817_011_296


def test_whole_model_parameters():
    assert arith.param_counts(n_layers=32, **OPT)["total"] == 6_864_430_176


def test_state_bytes():
    # bf16 parameters, fp32 LayerNorms, fp32 moments of every parameter.
    ln = arith.layernorm_params(4096, 8)
    assert ln == 139_264
    params = arith.param_counts(n_layers=8, **OPT)["total"]
    assert 2 * (params - ln) + 4 * ln + 2 * 4 * params == 20_313_418_688
    # fp16 weights, fp32 LayerNorms.
    ln32 = arith.layernorm_params(4096, 32)
    assert 2 * arith.param_counts(n_layers=32, **OPT)["total"] + 2 * ln32 == 13_729_925_312


def test_flops_per_token():
    # 6 x 1,817,011,296 + 12 x 8 x 4096 x 2048
    assert arith.train_flops_per_token(1_817_011_296, 8, 4096, 2048) == 11_707_374_144


def test_bounds_and_shares():
    assert arith.copy_bound_s(12_188_719_680) == pytest.approx(2 * 12_188_719_680 / 3.35e12)
    assert arith.copy_bound_s(4_061_528_064) * 1e3 == pytest.approx(2.4248, abs=1e-4)  # K2's bound in PERF.md
    assert arith.share_pct(2.425, 2.747) == pytest.approx(88.28, abs=0.01)
    # 100 steps of 4096 tokens in 30 s.
    assert arith.mfu_pct(100 * 4096 * 11_707_374_144, 30.0) == pytest.approx(16.16, abs=0.01)


@pytest.mark.parametrize("name, leaves", [("opt-6.7b-pp4s-adamw", 102), ("opt-6.7b-weights", 390)])
def test_trainer_matches_the_arithmetic(name, leaves):
    cfg = model_config(cells.config(name))
    with torch.device("meta"):
        model = Transformer(cfg)
    params = list(model.parameters())
    assert len(params) == leaves
    c = arith.param_counts(cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.max_seq_len)
    assert sum(p.numel() for p in params) == c["total"]
    fp32 = sum(p.numel() for p in params if p.dtype == torch.float32)
    assert fp32 == arith.layernorm_params(cfg.d_model, cfg.n_layers)
    assert all(p.dtype in (cfg.param_dtype, torch.float32) for p in params)


def test_train_state_bytes_on_the_meta_device():
    """The trainer's state after one AdamW update: 408 leaves (102 each of
    parameters, both moments and host step counters) and the bytes above."""
    from portbench.lib.trainer import adamw, train_state_tensors

    cfg = model_config(cells.config("opt-6.7b-pp4s-adamw"))
    with torch.device("meta"):
        model = Transformer(cfg)
    opt = adamw(model.parameters())
    for p in model.parameters():
        opt._state(p)
    named = train_state_tensors(model, opt)
    assert len(named) == 408
    device = sum(t.numel() * t.element_size() for _, t in named if t.device.type != "cpu")
    assert device == 20_313_418_688
    assert {t.dtype for n, t in named if "exp_avg" in n} == {torch.float32}
