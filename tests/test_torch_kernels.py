"""The port's kernels K1 (pack_slab), K2 (fork_copy) and K3 (copy_blocks).

On the CPU the wrappers run their plain PyTorch versions, which are held
here against the JAX package: K1's bytes must equal
``torchsnapshot_tpu.batcher._pack_to_device_bytes`` run on JAX CPU arrays
of the same values, and K3 must fill a target exactly as the JAX package's
shard consumer does (``np.copyto`` on the slices of its ``overlap``). K3's
descriptor table, which only the card reads, is also executed here by an
emulator of the kernel's block and grain walk, at a small block size. The
CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu import batcher as jbatcher
from torchsnapshot_tpu.io_preparers.sharded_array import overlap as joverlap

from torchsnapshot_tpu_torch import io_preparer, kernels
from torchsnapshot_tpu_torch.convert import from_numpy_tree

# Every K1 dtype torch has, as (torch dtype, numpy dtype).
_PACKABLE = [
    (torch.bool, np.bool_),
    (torch.int8, np.int8),
    (torch.int16, np.int16),
    (torch.int32, np.int32),
    (torch.int64, np.int64),
    (torch.uint8, np.uint8),
    (torch.uint16, np.uint16),
    (torch.uint32, np.uint32),
    (torch.uint64, np.uint64),
    (torch.float16, np.float16),
    (torch.float32, np.float32),
    (torch.float64, np.float64),
    (torch.bfloat16, ml_dtypes.bfloat16),
    (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
    (torch.float8_e5m2, ml_dtypes.float8_e5m2),
    (torch.float8_e4m3fnuz, ml_dtypes.float8_e4m3fnuz),
    (torch.float8_e5m2fnuz, ml_dtypes.float8_e5m2fnuz),
]
assert {t for t, _ in _PACKABLE} == kernels.PACKABLE_DTYPES


def _values(np_dtype, shape, rng):
    if np.dtype(np_dtype) == np.bool_:
        return rng.integers(0, 2, shape).astype(np.bool_)
    if np.dtype(np_dtype).kind in "iu":
        info = np.iinfo(np_dtype)
        return rng.integers(max(info.min, -1000), min(info.max, 1000), shape).astype(np_dtype)
    return rng.standard_normal(shape).astype(np_dtype)


def _members(np_dtype, seed):
    """0-dim, 0-size, odd counts (unaligned slab offsets) and a matrix."""
    rng = np.random.default_rng(seed)
    return [
        _values(np_dtype, (), rng),
        _values(np_dtype, (0, 3), rng),
        _values(np_dtype, (7,), rng),
        _values(np_dtype, (3, 5), rng),
        _values(np_dtype, (1,), rng),
    ]


def _reference_pack(arrays):
    with jax.enable_x64(True):
        arrs = tuple(jax.device_put(a) for a in arrays)
        packed = jbatcher._pack_to_device_bytes(jbatcher._pack_key(arrs), arrs)
        return np.asarray(packed)


@pytest.mark.parametrize("dtype", [t for t, _ in _PACKABLE], ids=str)
def test_pack_slab_plain_matches_reference(dtype):
    np_dtype = dict(_PACKABLE)[dtype]
    arrays = _members(np_dtype, seed=3)
    tensors = from_numpy_tree(arrays)
    assert all(t.dtype == dtype for t in tensors)
    got = kernels.pack_slab_plain(tensors)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _reference_pack(arrays))


def test_pack_slab_transposed_view_is_c_order():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    t = torch.from_numpy(a.copy()).t()  # a non-contiguous view
    assert not t.is_contiguous()
    got = kernels.pack_slab_plain([t, torch.tensor([True, False])])
    np.testing.assert_array_equal(got.numpy(), _reference_pack([a.T, np.array([True, False])]))


def test_pack_slab_wrapper_on_cpu_runs_the_plain_version():
    kernels.reset_launch_counts()
    ts = [torch.arange(5, dtype=torch.int16), torch.ones(2, 3).t()]
    assert torch.equal(kernels.pack_slab(ts), kernels.pack_slab_plain(ts))
    assert kernels.LAUNCHES["pack_slab"] == 0


def test_pack_slab_refuses_unpackable_dtype():
    with pytest.raises(TypeError):
        kernels.pack_slab([torch.zeros(2, dtype=torch.complex64)])


@pytest.mark.parametrize("dtype", [t for t, _ in _PACKABLE], ids=str)
def test_fork_copy_plain_is_bitwise_and_unaliased(dtype):
    tensors = from_numpy_tree(_members(dict(_PACKABLE)[dtype], seed=4))
    tensors.append(tensors[3].t())  # strided view
    copies = kernels.fork_copy(tensors)
    assert kernels.LAUNCHES["fork_copy"] == 0
    for t, c in zip(tensors, copies):
        assert c.dtype == t.dtype and c.shape == t.shape
        if t.numel():
            assert c.data_ptr() != t.data_ptr()
        assert torch.equal(
            c.contiguous().reshape(-1).view(torch.uint8),
            t.contiguous().reshape(-1).view(torch.uint8),
        )


def test_dense_precondition():
    m = torch.zeros(4, 6)
    assert kernels._is_dense(m.t())
    assert not kernels._is_dense(m[:, :3])
    assert kernels._is_dense(torch.zeros(0, 3).t())


def test_fork_bisects_on_out_of_memory_then_host_captures():
    """The reference's bisection: a group whose fork fails is split in two
    (depth 2); a quarter that still fails is captured through the host."""
    group = [torch.full((n,), float(n)) for n in (1, 2, 3, 4, 5, 6, 7, 8)]
    calls = []

    def fork(g):
        calls.append(len(g))
        if sum(t.numel() for t in g) > 10:
            raise torch.cuda.OutOfMemoryError("simulated")
        return [t.clone() for t in g]

    captured = []
    out = io_preparer._fork_or_capture(group, fork, lambda g: [t.clone() for t in g], captured)
    assert [torch.equal(a, b) for a, b in zip(out, group)] == [True] * 8
    # [1..4] fits at depth 1; [5..8] fails and splits; its halves [5,6]
    # and [7,8] still fail at depth 2 and are captured.
    assert calls == [8, 4, 4, 2, 2]
    assert captured == group[4:]


# ---------------------------------------------------------------------------
# K3: copy_blocks
# ---------------------------------------------------------------------------

# (piece shape, piece offsets, target shape, target offsets): 0-d, empty,
# 1-D, odd widths, 2-D column blocks and a 3-D block cut on two dims.
_K3_CASES = [
    ((), (), (), ()),
    ((0, 3), (0, 0), (0, 3), (0, 0)),
    ((7,), (3,), (5,), (0,)),
    ((5, 3), (0, 0), (5, 7), (0, 2)),
    ((4, 9), (2, 0), (6, 5), (0, 3)),
    ((3, 4, 5), (1, 0, 2), (4, 3, 6), (0, 2, 0)),
    ((6, 1, 5), (0, 0, 0), (6, 1, 3), (0, 0, 1)),
]


def _k3_inputs(np_dtype, case, seed):
    piece_shape, piece_off, tgt_shape, tgt_off = case
    rng = np.random.default_rng(seed)
    src = _values(np_dtype, piece_shape, rng)
    dst = _values(np_dtype, tgt_shape, rng)
    ov = joverlap(piece_off, piece_shape, tgt_off, tgt_shape)
    return src, dst, ov


def _as_tensor(a):
    return from_numpy_tree(a)


def _bytes_of(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("case", _K3_CASES, ids=str)
@pytest.mark.parametrize("dtype", [t for t, _ in _PACKABLE], ids=str)
def test_copy_blocks_plain_matches_reference_consumer(dtype, case):
    np_dtype = dict(_PACKABLE)[dtype]
    src, dst, ov = _k3_inputs(np_dtype, case, seed=5)
    want = dst.copy()
    if ov is not None:
        src_sl, dst_sl = ov
        np.copyto(want[dst_sl] if dst_sl else want, src[src_sl] if src_sl else src, casting="no")
    t_src, t_dst = _as_tensor(src), _as_tensor(dst)
    if ov is not None:
        kernels.reset_launch_counts()
        kernels.copy_blocks([(t_src[ov[0]], t_dst[ov[1]])])
        assert kernels.LAUNCHES["copy_blocks"] == 0
    np.testing.assert_array_equal(
        _bytes_of(t_dst).numpy(), np.ascontiguousarray(want).reshape(-1).view(np.uint8)
    )


def _emulate_copy_blocks(table, total, chunk=48):
    """Run K3's table as the kernel does (csrc/tss_kernels.cu), on host
    memory: blocks of ``chunk`` bytes each binary-search their first
    rectangle and copy their share in grain units, checking the alignment
    the kernel's vector loads rely on."""
    begins = table["begin"]
    for lo in range(0, total, chunk):
        hi = min(lo + chunk, total)
        i = max(int(np.searchsorted(begins, lo, side="right")) - 1, 0)
        while i < len(table) and table["begin"][i] < hi:
            d = {k: int(table[k][i]) for k in table.dtype.names}
            i += 1
            x = max(lo - d["begin"], 0)
            y = min(hi, d["begin"] + d["nbytes"]) - d["begin"]
            if x >= y:
                continue
            g = d["grain"]
            assert x % g == 0 and y % g == 0
            upr = d["row_bytes"] // g
            plane = upr * d["rows"]
            for u in range(x // g, y // g):
                o, rem = divmod(u, plane)
                r, c = divmod(rem, upr)
                s = d["src"] + o * d["src_opitch"] + r * d["src_pitch"] + c * g
                t = d["dst"] + o * d["dst_opitch"] + r * d["dst_pitch"] + c * g
                assert s % g == 0 and t % g == 0
                ctypes.memmove(t, s, g)


def _k3_view_pairs(seed):
    """Strided views of every kind the restore and the take produce, each
    destination in a tensor of its own."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(9, 12, 5, generator=g)
    odd = torch.randint(0, 255, (37,), generator=g, dtype=torch.uint8)
    bf = torch.randn(16, 64, generator=g).to(torch.bfloat16)

    def b():
        return torch.zeros(12, 9, 5)

    return [
        (a[2:7, 3:11, 1:4], b()[4:9, 0:8, 2:5]),  # 3-D on both sides
        (a[:, 0, :], b()[0:9, 3, :]),  # rows with a pitch
        (a[1:3].transpose(0, 1), b()[0:12, 4:6, :]),  # a transposed source
        (a[1:3, :, 2], b()[:, 2:4, 1].t()),  # strided last dim on both sides
        (odd[1:34], torch.zeros(40, dtype=torch.uint8)[5:38]),  # odd length, odd addresses
        (bf[:, 16:48], torch.zeros(32, 32, dtype=torch.bfloat16)[:16]),  # bf16 column block
        (torch.tensor(3.5), torch.zeros(())),  # 0-d
        (a[0:0, :9], b()[0:0]),  # empty
    ]


@pytest.mark.parametrize("chunk", [16, 48, 4096])
def test_rect_table_emulated_equals_plain(chunk):
    pairs = _k3_view_pairs(7)
    want = [dst.clone() for _, dst in pairs]
    kernels.copy_blocks_plain([(s, w) for (s, _), w in zip(pairs, want)])
    table, total = kernels.rect_table(pairs)
    assert (table["begin"] % 16 == 0).all()
    _emulate_copy_blocks(table, total, chunk)
    for (_, dst), w in zip(pairs, want):
        assert torch.equal(_bytes_of(dst), _bytes_of(w))


def test_rect_table_collapses_contiguous_dims():
    a = torch.zeros(4, 6, 8)
    b = torch.zeros(4, 6, 8)
    table, total = kernels.rect_table([(a, b)])
    assert len(table) == 1 and total == a.numel() * 4
    assert table["rows"][0] == 1 and table["row_bytes"][0] == total and table["grain"][0] == 16
    # The main path's reshard rectangle: half the columns of each row.
    src = torch.zeros(2048, 8192, dtype=torch.bfloat16)
    dst = torch.zeros(2048, 16384, dtype=torch.bfloat16)[:, 8192:]
    table, total = kernels.rect_table([(src, dst)])
    assert len(table) == 1
    assert (table["rows"][0], table["row_bytes"][0]) == (2048, 16384)
    assert (table["src_pitch"][0], table["dst_pitch"][0]) == (16384, 32768)
    # A 4-D block merges where it can; one that no merge brings under
    # three dims is cut into rectangles along its outermost dim.
    big = torch.zeros(3, 4, 5, 6)
    table, _ = kernels.rect_table([(big[:, :, :, :2], torch.zeros(3, 4, 5, 2))])
    assert len(table) == 1
    table, _ = kernels.rect_table([(big[:, :3, :, :2], torch.zeros(3, 3, 5, 2))])
    assert len(table) == 1
    table, _ = kernels.rect_table([(big[:, :3, :4, :2], torch.zeros(3, 3, 4, 2))])
    assert len(table) == 3 and (table["rows"] == 4).all()


def test_copy_blocks_checks_its_pairs():
    with pytest.raises(ValueError, match="does not match"):
        kernels.copy_blocks([(torch.zeros(2, 3), torch.zeros(3, 2))])
    with pytest.raises(ValueError, match="overlaps itself"):
        kernels.copy_blocks([(torch.zeros(4), torch.zeros(1).expand(4))])
    kernels.copy_blocks([])
