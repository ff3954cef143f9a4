"""The port's pytree train-state adapter, the optimizer-state
materialisation, and checkpointing a model in training: round trips, the
cross-package path components, the DTensor-optimizer restore fault, a
bit-identical resume on the CPU, and ``async_take`` racing an optimizer
step. Inputs come from a seed with numpy; every comparison is bit-exact."""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.tricks import train_state as jtrain

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import convert, dryrun
from torchsnapshot_tpu_torch.manifest import DictEntry
from torchsnapshot_tpu_torch.models import moe as tmoe
from torchsnapshot_tpu_torch.models.transformer import TransformerConfig
from torchsnapshot_tpu_torch.test_utils import run_with_processes
from torchsnapshot_tpu_torch.tricks.train_state import (
    Box,
    PyTreeStateful,
    _path_str,
    init_optimizer_state,
    train_state_stateful,
)

Moments = collections.namedtuple("Moments", ["mu", "nu"])
TINY = TransformerConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16)


def _numpy_tree(seed=0):
    """Nested dicts, a list, a tuple and a namedtuple of numpy leaves of
    several dtypes (bf16 through ml_dtypes)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "dense": {
                "kernel": rng.standard_normal((4, 8)).astype(np.float32),
                "bias": rng.standard_normal(8).astype(jnp.bfloat16),
            },
            "emb": [rng.integers(0, 9, (3,)).astype(np.int32), rng.standard_normal(2).astype(np.float16)],
        },
        "opt": (Moments(rng.standard_normal((4, 8)).astype(np.float32), rng.standard_normal(8).astype(np.float32)),),
    }


def _zeros_like(tree):
    return pytree.tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t, tree)


def _assert_same_leaves(got, want):
    g, gspec = pytree.tree_flatten(got)
    w, wspec = pytree.tree_flatten(want)
    assert gspec == wspec
    for a, b in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert dryrun.same_bits(a, b)
        else:
            assert a == b


def _adamw_state(seed=0):
    model = tmoe.init_params(tmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4), seed=seed, device="cpu")
    optimizer = dryrun.adamw(model.parameters())
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen).to(p.dtype)
    optimizer.step()
    return model, optimizer


def test_path_components_are_the_jax_packages():
    tree = _numpy_tree()
    jax_paths = sorted(jtrain._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])
    port_paths = sorted(_path_str(p) for p, _ in pytree.tree_flatten_with_path(tree)[0])
    assert port_paths == jax_paths
    assert "opt/0/mu" in port_paths and "params/emb/1" in port_paths
    assert _path_str(pytree.tree_flatten_with_path(np.ones(2))[0][0][0]) == "value"


def test_optimizer_state_roundtrip_keeps_the_structure(tmp_path):
    """The counterpart of ``test_optax_state_roundtrip``: parameters and an
    AdamW state dict (int-keyed state, param_groups with a betas tuple and
    None entries) restore bit-exact into a zeroed tree of the same
    structure."""
    model, optimizer = _adamw_state()
    params = {n: p.detach() for n, p in model.named_parameters()}
    holder = Box({"params": params, "opt_state": optimizer.state_dict(), "step": 3})
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"ts": PyTreeStateful(holder)})
    restored = Box(_zeros_like(holder.value))
    restored.value["step"] = 0
    tts.Snapshot(path).restore({"ts": train_state_stateful(restored)}, device="cpu")
    _assert_same_leaves(restored.value, holder.value)
    assert restored.value["step"] == 3
    assert tts.Snapshot(path).read_object("0/ts/opt_state/state/1/step", device="cpu").item() == 1.0


def test_missing_leaf_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    tts.Snapshot.take(path, {"ts": PyTreeStateful(Box({"a": torch.ones(3)}))})
    grown = Box({"a": torch.ones(3), "b": torch.ones(4)})
    with pytest.raises(KeyError, match="missing pytree leaf"):
        tts.Snapshot(path).restore({"ts": PyTreeStateful(grown)}, device="cpu")


def test_jax_pytree_snapshot_restores_into_the_port(tmp_path):
    """A JAX ``PyTreeStateful`` snapshot restores into the port's with the
    same logical paths, bit-exact."""
    tree = _numpy_tree(1)
    path = str(tmp_path / "jax")
    jts.Snapshot.take(path, {"ts": jtrain.PyTreeStateful(jtrain.Box(jax.tree.map(jnp.asarray, tree)))})
    target = Box(_zeros_like(convert.from_numpy_tree(tree, device="cpu")))
    tts.Snapshot(path).restore({"ts": PyTreeStateful(target)}, device="cpu")
    _assert_same_leaves(target.value, convert.from_numpy_tree(tree, device="cpu"))
    port_path = str(tmp_path / "port")
    tts.Snapshot.take(port_path, {"ts": PyTreeStateful(Box(convert.from_numpy_tree(tree, device="cpu")))})
    leaves = lambda m: sorted(k for k, e in m.items() if e.type not in ("dict", "list"))  # noqa: E731
    assert leaves(tts.Snapshot(port_path).get_manifest()) == leaves(jts.Snapshot(path).get_manifest())


def test_port_pytree_snapshot_restores_into_jax(tmp_path):
    tree = _numpy_tree(2)
    path = str(tmp_path / "port")
    tts.Snapshot.take(path, {"ts": PyTreeStateful(Box(convert.from_numpy_tree(tree, device="cpu")))})
    target = jtrain.Box(jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), tree))
    jts.Snapshot(path).restore({"ts": jtrain.PyTreeStateful(target)})
    for a, b in zip(jax.tree_util.tree_leaves(target.value), jax.tree_util.tree_leaves(tree)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_init_optimizer_state_changes_no_parameter():
    """Materialised state is what the first ``step()`` would create; the
    next step equals a fresh optimizer's first step, bit for bit."""
    model, _ = _adamw_state(seed=1)
    twin, _ = _adamw_state(seed=1)
    before = [p.detach().clone() for p in model.parameters()]
    optimizer = init_optimizer_state(dryrun.adamw(model.parameters()))
    for p, b in zip(model.parameters(), before):
        state = optimizer.state[p]
        assert dryrun.same_bits(p, b)
        assert state["step"].device.type == "cpu" and state["step"].dtype == torch.float32
        assert float(state["step"]) == 0.0
        assert dryrun.same_bits(state["exp_avg"], torch.zeros_like(p))
        assert dryrun.same_bits(state["exp_avg_sq"], torch.zeros_like(p))
    fresh = dryrun.adamw(twin.parameters())
    gen = torch.Generator().manual_seed(5)
    for p, q in zip(model.parameters(), twin.parameters()):
        p.grad = torch.randn(p.shape, generator=gen).to(p.dtype)
        q.grad = p.grad.clone()
    optimizer.step()
    fresh.step()
    for p, q in zip(model.parameters(), twin.parameters()):
        assert dryrun.same_bits(p, q)
    with pytest.raises(TypeError, match="Adam"):
        init_optimizer_state(torch.optim.SGD(model.parameters(), lr=0.1))


def test_optimizer_restore_keeps_int_state_keys(tmp_path):
    """An optimizer's state is keyed by int parameter indices. The restore
    once added their string forms beside them (manifest container
    reconstruction), so the next take pickled the whole state as one
    object."""
    model, optimizer = _adamw_state()
    path = str(tmp_path / "a")
    tts.Snapshot.take(path, {"optim": optimizer})
    twin, _ = _adamw_state(seed=3)
    restored = init_optimizer_state(dryrun.adamw(twin.parameters()))
    tts.Snapshot(path).restore({"optim": restored}, device="cpu")
    assert sorted(restored.state_dict()["state"], key=str) == sorted(optimizer.state_dict()["state"], key=str)
    assert all(isinstance(k, torch.Tensor) for k in restored.state)
    tts.Snapshot.take(str(tmp_path / "b"), {"optim": restored})
    assert isinstance(tts.Snapshot(str(tmp_path / "b")).get_manifest()["0/optim/state"], DictEntry)


def _dtensor_optimizer_restore(rank, world_size, root):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("ep",))
    cfg = tmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4)

    def sharded(seed):
        model = tmoe.shard_params_ep(tmoe.init_params(cfg, seed=seed, device="cpu"), mesh)
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        return model

    model = sharded(0)
    optimizer = dryrun.adamw(model.parameters())
    optimizer.step()
    path = os.path.join(root, "ckpt")
    tts.Snapshot.take(path, {"model": model, "optim": optimizer})

    # The fault: a fresh optimizer has no state, so the restore builds plain
    # tensors of the global shape, which the next step cannot use.
    plain = sharded(1)
    plain_optimizer = dryrun.adamw(plain.parameters())
    tts.Snapshot(path).restore({"model": plain, "optim": plain_optimizer}, device="cpu")
    exp_avg = plain_optimizer.state[plain.w_up]["exp_avg"]
    assert not isinstance(exp_avg, DTensor) and exp_avg.shape == plain.w_up.shape
    with pytest.raises(RuntimeError, match="mixed torch.Tensor and DTensor"):
        plain_optimizer.step()

    # The fix: materialised state gives DTensor targets, filled in place.
    fresh = sharded(1)
    fresh_optimizer = init_optimizer_state(dryrun.adamw(fresh.parameters()))
    ptrs = {k: v.to_local().data_ptr() for k, v in fresh_optimizer.state[fresh.w_up].items() if k != "step"}
    tts.Snapshot(path).restore({"model": fresh, "optim": fresh_optimizer}, device="cpu")
    saved_by_name = {n: optimizer.state[p] for n, p in model.named_parameters()}
    for name, p in fresh.named_parameters():
        saved = saved_by_name[name]
        state = fresh_optimizer.state[p]
        for key in ("exp_avg", "exp_avg_sq"):
            assert isinstance(state[key], DTensor) and state[key].placements == p.placements
            assert dryrun.same_bits(state[key].to_local(), saved[key].to_local()), (name, key)
        assert dryrun.same_bits(state["step"], saved["step"])
    assert {k: v.to_local().data_ptr() for k, v in fresh_optimizer.state[fresh.w_up].items() if k != "step"} == ptrs
    fresh_optimizer.step()
    optimizer.step()
    for p, q in zip(fresh.parameters(), model.parameters()):
        assert dryrun.same_bits(p.to_local(), q.to_local())


def test_dtensor_optimizer_restore_needs_materialised_state(tmp_path):
    run_with_processes(_dtensor_optimizer_restore, 2, args=(str(tmp_path),), process_group=True)


def test_resume_is_bit_identical_on_cpu(tmp_path):
    """Steps 1-3, ``async_take`` with steps 4-6 at once, a restore into a
    fresh model and optimizer, steps 4-6 again: every loss, parameter and
    moment bit-identical; a sync take of step 6 restored in place."""
    out = dryrun.train_checkpoint_resume(TINY, str(tmp_path), device="cpu", batch=2)
    assert len(out["losses"]) == 6 and all(np.isfinite(out["losses"]))
    n_params = 12 * TINY.n_layers + 6
    assert out["n_tensors"] == 4 * n_params  # parameters, step, exp_avg, exp_avg_sq
    assert not os.listdir(tmp_path)


def test_async_take_then_step_holds_the_pre_step_state(tmp_path):
    model, optimizer = _adamw_state(seed=2)
    app = {"model": model, "optim": optimizer}
    before = [(n, t.detach().clone()) for n, t in dryrun.train_state_tensors(model, optimizer)]
    pending = tts.Snapshot.async_take(str(tmp_path / "s"), app)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()  # at once, before the drain ends
    pending.wait()
    twin, _ = _adamw_state(seed=9)
    twin_optimizer = init_optimizer_state(dryrun.adamw(twin.parameters()))
    tts.Snapshot(str(tmp_path / "s")).restore({"model": twin, "optim": twin_optimizer}, device="cpu")
    got = dryrun.train_state_tensors(twin, twin_optimizer)
    assert [n for n, _ in got] == [n for n, _ in before]
    for (name, a), (_, b) in zip(got, before):
        assert dryrun.same_bits(a, b), name
