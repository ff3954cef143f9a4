"""The port's workloads against the JAX package's: the transformer and the
MoE layer with the JAX weights carried across, AdamW against optax, the
TP/FSDP and EP sharding rules against the JAX ``NamedSharding``s, the
multi-rank dry run, and EP reshards on gloo ranks. Inputs come from a seed
with numpy; each test states its tolerance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

import torchsnapshot_tpu as jts
from torchsnapshot_tpu.models import moe as jmoe
from torchsnapshot_tpu.models import transformer as jt
from torchsnapshot_tpu.tricks import train_state as jtrain

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import convert, dryrun
from torchsnapshot_tpu_torch.io_preparers.sharded_array import placement_offsets_sizes
from torchsnapshot_tpu_torch.models import moe as tmoe
from torchsnapshot_tpu_torch.models import transformer as tt
from torchsnapshot_tpu_torch.test_utils import run_with_processes
from torchsnapshot_tpu_torch.tricks import train_state as ttrain

# The JAX entry's size (``__graft_entry__.py``), at 64 positions.
GRAFT = dict(vocab_size=1024, d_model=256, n_heads=4, n_layers=2, d_ff=1024, max_seq_len=64)


def _configs(dtype: str):
    jd = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return (
        jt.TransformerConfig(**GRAFT, dtype=jd, param_dtype=jd),
        tt.TransformerConfig(**GRAFT, dtype=td, param_dtype=td),
    )


def _jax_params(jcfg, seed=0):
    """JAX init, with every leaf (biases and LayerNorm parameters too)
    perturbed from a seed so the weight mapping is exercised."""
    model, params = jt.init_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.device_get(params),
    )
    return model, params


def _port_model(tcfg, params):
    model = tt.init_params(tcfg, seed=7, device="cpu")
    model.load_state_dict(convert.transformer_params_from_jax(params), strict=True)
    return model


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _tree_max_abs(a, b) -> float:
    return max(jax.tree_util.tree_leaves(jax.tree.map(_max_abs, a, b)))


@pytest.fixture(scope="module")
def fp32_case():
    """The fp32 JAX transformer, its perturbed parameters, tokens, and the
    JAX logits, loss and gradients on them."""
    jcfg, tcfg = _configs("fp32")
    jmodel, params = _jax_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, GRAFT["vocab_size"], (2, 64)).astype(np.int32)
    logits = np.asarray(jmodel.apply({"params": params}, tokens[:, :-1]))
    loss, grads = jax.value_and_grad(lambda p: jt.loss_fn(jmodel, p, jnp.asarray(tokens)))(params)
    return tcfg, params, tokens, logits, float(loss), jax.device_get(grads)


def test_transformer_fp32_matches_flax(fp32_case):
    """fp32: logits within 1e-4 max abs, loss within 1e-5 relative, every
    gradient within 1e-4 max abs."""
    tcfg, params, tokens, want_logits, want_loss, want_grads = fp32_case
    model = _port_model(tcfg, params)
    t = torch.from_numpy(tokens).long()
    logits = model(t[:, :-1])
    assert logits.dtype == torch.float32 and logits.shape == want_logits.shape
    assert _max_abs(logits.detach().numpy(), want_logits) <= 1e-4
    loss = tt.loss_fn(model, t)
    loss.backward()
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    grads = convert.transformer_params_to_jax({n: p.grad for n, p in model.named_parameters()})
    assert _tree_max_abs(grads, want_grads) <= 1e-4


def test_transformer_bf16_matches_flax():
    """bf16: loss within 1e-2 relative. The logits differ by rounding
    order (bf16 matmuls, biases added before or after rounding): measured
    0.042 max abs on this input; held to 0.1."""
    jcfg, tcfg = _configs("bf16")
    jmodel, params = _jax_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, GRAFT["vocab_size"], (2, 64)).astype(np.int32)
    want_logits = np.asarray(jmodel.apply({"params": params}, tokens[:, :-1]))
    want_loss = float(jt.loss_fn(jmodel, params, jnp.asarray(tokens)))

    model = _port_model(tcfg, params)
    assert model.block_0.ln1.weight.dtype == torch.float32  # flax keeps LayerNorm params fp32
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits = model(t[:, :-1])
        loss = tt.loss_fn(model, t).item()
    assert logits.dtype == torch.float32  # lm_head computes in fp32
    assert _max_abs(logits.numpy(), want_logits) <= 0.1
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)


def test_adamw_step_matches_optax(fp32_case):
    """One AdamW step (``dryrun.adamw``: optax's ``adamw(1e-3)`` defaults)
    from the same fp32 parameters and gradients: parameters within 1e-6."""
    tcfg, params, _, _, _, grads = fp32_case
    tx = optax.adamw(1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = jax.device_get(optax.apply_updates(params, updates))

    model = _port_model(tcfg, params)
    torch_grads = convert.transformer_params_from_jax(grads)
    for name, p in model.named_parameters():
        p.grad = torch_grads[name]
    dryrun.adamw(model.parameters()).step()
    got = convert.transformer_params_to_jax(model.state_dict())
    assert _tree_max_abs(got, want) <= 1e-6


def test_moe_fp32_matches_flax_with_the_same_routing():
    """fp32 (bf16 routing flips on rounding): the top-1 expert of every
    token matches, the output within 1e-5 max abs."""
    cfg = jmoe.MoEConfig()
    jmodel, params = jmoe.init_params(cfg, seed=0)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(params))
    x = np.random.default_rng(3).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, x))
    want_route = np.asarray(jnp.argmax(x @ params["gate"]["kernel"], axis=-1))

    model = tmoe.init_params(tmoe.MoEConfig(), seed=4, device="cpu").float()
    model.load_state_dict(convert.moe_params_from_jax(params), strict=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        route = model.gate(xt).argmax(-1)
        got = model(xt)
    assert np.array_equal(route.numpy(), want_route)
    assert _max_abs(got.numpy(), want) <= 1e-5


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("which", ["transformer", "moe"])
def test_weights_cross_bit_exact_both_ways(which):
    """JAX tree -> port state_dict -> module -> state_dict -> JAX tree is
    the identity on every byte, and every module parameter is named."""
    if which == "transformer":
        _, params = jt.init_params(_configs("bf16")[0], seed=5)
        module = tt.init_params(_configs("bf16")[1], seed=1, device="cpu")
        from_jax, to_jax = convert.transformer_params_from_jax, convert.transformer_params_to_jax
    else:
        _, params = jmoe.init_params(jmoe.MoEConfig(), seed=5)
        module = tmoe.init_params(tmoe.MoEConfig(), seed=1, device="cpu")
        from_jax, to_jax = convert.moe_params_from_jax, convert.moe_params_to_jax
    params = jax.device_get(params)
    module.load_state_dict(from_jax(params), strict=True)
    back = to_jax(module.state_dict())
    flat_want = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    flat_got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert sorted(flat_got) == sorted(flat_want)
    for k, want in flat_want.items():
        got = flat_got[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(_bits(got), _bits(want)), k


class _Mesh:
    """What the sharding rules read of a DeviceMesh, without processes."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(shape)


@pytest.mark.parametrize(
    "sizes",
    [
        GRAFT,
        # Odd vocab and positions, 3 heads: the rule's fallback replicates.
        dict(vocab_size=1001, d_model=96, n_heads=3, n_layers=1, d_ff=200, max_seq_len=33),
    ],
    ids=["graft", "uneven"],
)
def test_param_spec_gives_each_device_the_jax_block(sizes):
    """On a 2x2 ("dp", "tp") mesh, every parameter's placements give each
    mesh coordinate the same global block (in flax's layout) as the JAX
    rule's NamedSharding on 4 of the 8 CPU devices."""
    jmodel = jt.Transformer(jt.TransformerConfig(**sizes))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    tmesh = _Mesh((2, 2), ("dp", "tp"))
    with torch.device("meta"):
        names = dict(tt.Transformer(tt.TransformerConfig(**sizes)).named_parameters())
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        jpath = jtrain._path_str(path)
        spec = jt._fit_spec(jt.param_spec(jpath), leaf.shape, jmesh)
        indices = NamedSharding(jmesh, spec).devices_indices_map(leaf.shape)
        parts = jpath.split("/")
        torch_name = ".".join(parts[:-1] + [{"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(parts[-1], parts[-1])])
        transposed = parts[-2] in ("up", "down", "lm_head") and parts[-1] == "kernel"
        tshape = tuple(leaf.shape[::-1] if transposed else leaf.shape)
        assert tuple(names[torch_name].shape) == tshape, torch_name
        placements = tt.param_spec(torch_name, tshape, tmesh)
        for i in range(2):
            for j in range(2):
                offs, szs = placement_offsets_sizes(tshape, (2, 2), placements, (i, j))
                if transposed:
                    offs, szs = offs[::-1], szs[::-1]
                want = [
                    (s.start or 0, n if s.stop is None else s.stop)
                    for s, n in zip(indices[jmesh.devices[i, j]], leaf.shape)
                ]
                assert [(o, o + n) for o, n in zip(offs, szs)] == want, (jpath, i, j)
        checked += 1
    assert checked == len(names)


def test_pos_embed_rule_is_not_the_embed_rule():
    mesh = _Mesh((2, 2), ("dp", "tp"))
    from torch.distributed.tensor import Replicate, Shard

    assert tt.param_spec("pos_embed.weight", (64, 256), mesh) == [Shard(0), Replicate()]
    assert tt.param_spec("embed.weight", (1024, 256), mesh) == [Shard(0), Shard(1)]
    assert tt.param_spec("embed.weight", (1024, 256), mesh, fsdp=False) == [Replicate(), Shard(1)]
    assert tmoe.ep_spec("w_up", (8, 4, 4), _Mesh((2, 1), ("dp", "ep"))) == [Replicate(), Shard(0)]


def test_entry_forward_runs():
    model, (tokens,) = dryrun.entry(device="cpu")
    with torch.no_grad():
        out = model(tokens)
    assert out.shape == (2, 64, dryrun.ENTRY_CFG.vocab_size) and torch.isfinite(out).all()


def test_dryrun_multichip_on_four_gloo_ranks():
    """One AdamW step on (dp=2, tp=2)-sharded parameters and moments (equal
    to the full-tensor step's blocks), a take, and bit-exact restores into
    the same, the transposed and a flat mesh."""
    dryrun.dryrun_multichip(4, device="cpu", timeout_s=240)


def _same_local(dt, full: torch.Tensor) -> bool:
    mesh = dt.device_mesh
    want = convert.local_shard_of(full, mesh.shape, dt.placements, mesh.get_coordinate())
    return dryrun.same_bits(dt.to_local(), want)


def _ep_reshard(rank, world_size, root):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    cfg = tmoe.MoEConfig()
    ep2 = DeviceMesh("cpu", [0, 1], mesh_dim_names=("ep",))
    ep1 = DeviceMesh("cpu", [[0], [1]], mesh_dim_names=("dp", "ep"))
    ref = dict(tmoe.init_params(cfg, seed=0, device="cpu").named_parameters())
    for name, save_mesh, load_mesh in (("ep2_to_ep1", ep2, ep1), ("ep1_to_ep2", ep1, ep2)):
        model = tmoe.shard_params_ep(tmoe.init_params(cfg, seed=0, device="cpu"), save_mesh)
        path = os.path.join(root, name)
        tts.Snapshot.take(path, {"moe": model})
        target = tmoe.shard_params_ep(tmoe.init_params(cfg, seed=1, device="cpu"), load_mesh)
        ptrs = {n: p.to_local().data_ptr() for n, p in target.named_parameters()}
        tts.Snapshot(path).restore({"moe": target}, device="cpu")
        for n, p in target.named_parameters():
            assert p.to_local().data_ptr() == ptrs[n], (name, n)
            assert _same_local(p, ref[n].detach()), (name, n)
        assert Shard(0) in target.w_up.placements
        if load_mesh is ep2:
            assert target.w_up.to_local().shape[0] == cfg.n_experts // 2


def test_moe_ep_reshard_on_gloo_ranks(tmp_path):
    """Saved at EP degree 2, restored at EP 1 on a (dp=2, ep=1) mesh, and
    the reverse; bit-exact, in place."""
    run_with_processes(_ep_reshard, 2, args=(str(tmp_path),), process_group=True)


def _restore_jax_ep8(rank, world_size, path, want):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("ep",))
    cfg = tmoe.MoEConfig()
    zeros = lambda shape: torch.zeros(shape, dtype=torch.bfloat16)  # noqa: E731
    tree = {
        "gate": {"kernel": torch.zeros(cfg.d_model, cfg.n_experts)},
        "w_up": convert.dtensor_from_tensor(zeros((8, cfg.d_model, cfg.d_ff)), mesh, tmoe.ep_spec("w_up", (), mesh)),
        "w_down": convert.dtensor_from_tensor(zeros((8, cfg.d_ff, cfg.d_model)), mesh, tmoe.ep_spec("w_down", (), mesh)),
    }
    box = ttrain.Box(tree)
    tts.Snapshot(path).restore({"moe": ttrain.PyTreeStateful(box)}, device="cpu")
    got = box.value
    assert dryrun.same_bits(got["gate"]["kernel"], convert.from_numpy_tree(want["gate"]["kernel"]))
    for k in ("w_up", "w_down"):
        assert got[k].to_local().shape[0] == 4
        assert _same_local(got[k], convert.from_numpy_tree(want[k])), k


def test_jax_ep8_snapshot_restores_into_port_ep2_dtensors(tmp_path):
    """The JAX package's snapshot of the MoE sharded over 8 devices (EP 8,
    as ``tests/test_moe.py``) restores into the port's EP-2 DTensors on two
    gloo ranks, bit-exact."""
    _, params = jmoe.init_params(jmoe.MoEConfig(), seed=0)
    sharded = jmoe.shard_params_ep(params, Mesh(np.array(jax.devices()[:8]), ("ep",)))
    path = str(tmp_path / "ckpt")
    jts.Snapshot.take(path, {"moe": jtrain.PyTreeStateful(jtrain.Box(sharded))})
    want = jax.device_get(params)
    run_with_processes(_restore_jax_ep8, 2, args=(path, want), process_group=True)
