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

import bisect
import ctypes
import math

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
    tensors = from_numpy_tree(arrays, device="cpu")
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
    tensors = from_numpy_tree(_members(dict(_PACKABLE)[dtype], seed=4), device="cpu")
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
    return from_numpy_tree(a, device="cpu")


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


def _emulate_row_offsets(d, r):
    """Source and destination byte offsets of row ``r``, as the kernel's
    ``row_offsets`` finds them: fast divmods by the dims' sizes, innermost
    first, plain division when the rectangle has 2**32 rows or more."""
    so = dso = 0
    nd = d["ndim"]
    for k in range(nd):
        if k + 1 == nd:
            i = r
        elif d["rows"] >= 1 << 32:
            r, i = divmod(r, d["size"][k])
        else:
            assert r < 1 << 32
            q = kernels.fast_div(r, d["mul"][k], d["shift"][k])
            i, r = r - q * d["size"][k], q
        so += i * d["src_stride"][k]
        dso += i * d["dst_stride"][k]
    return so, dso


def _emulate_copies(d, items, g, seen):
    """One thread's batch: every load first, then every store."""
    loaded = []
    for c, so, dso in items:
        s = d["src"] + so + c * g
        t = d["dst"] + dso + c * g
        assert s % g == 0 and t % g == 0  # the kernel's T-sized accesses
        loaded.append((t, ctypes.string_at(s, g)))
    for t, data in loaded:
        assert t not in seen  # each unit is copied once
        seen.add(t)
        ctypes.memmove(t, data, g)


def _emulate_wide_rows(d, u0, u1, upr, g, threads, seen):
    r0, c0 = divmod(u0, upr)
    for tid in range(threads):
        r, c, u = r0, c0 + tid, u0 + tid
        if c >= upr:
            c, r = c - upr, r + 1
        while u < u1:
            items = []
            for _ in range(kernels.K3_UNROLL):
                if u < u1:
                    items.append((c, *_emulate_row_offsets(d, r)))
                u, c = u + threads, c + threads
                if c >= upr:  # rows hold at least ``threads`` units: one wrap at most
                    c, r = c - upr, r + 1
            _emulate_copies(d, items, g, seen)


def _emulate_narrow_rows(d, u0, u1, upr, g, threads, seen):
    lg = 5 if upr >= 32 else (upr - 1).bit_length()
    lanes = 1 << lg
    groups = threads >> lg
    csteps = -(-upr // lanes)
    rb = (u1 - 1) // upr
    for tid in range(threads):
        lane = tid & (lanes - 1)
        r, j = u0 // upr + (tid >> lg), 0
        while r <= rb:
            items = []
            for _ in range(kernels.K3_UNROLL):
                if r > rb:
                    break
                c = lane + (j << lg)
                if c < upr and u0 <= r * upr + c < u1:
                    items.append((c, *_emulate_row_offsets(d, r)))
                j += 1
                if j == csteps:
                    j, r = 0, r + groups
            _emulate_copies(d, items, g, seen)


def _emulate_copy_blocks(table, total, chunk=None, threads=kernels.K3_THREADS, sms=132):
    """Run K3's table as the kernel does (csrc/tss_kernels.cu), on host
    memory: ``ceil(total / chunk)`` blocks (``chunk`` by the wrapper's rule
    for ``sms`` SMs unless given), each binary-searching its first
    rectangle and copying its share in grain units, by lane groups with
    fast-divmod row lookups for narrow rows and by streaming units across
    row ends for wide ones, ``K3_UNROLL`` loads before their stores. Checks the alignment the
    kernel's vector accesses rely on and that every unit of every
    rectangle is copied exactly once."""
    if chunk is None:
        chunk = kernels.k3_chunk_bytes(total, sms)
    assert chunk % 16 == 0
    rects = [{k: (list(map(int, table[k][i])) if table[k].ndim > 1 else int(table[k][i]))
              for k in table.dtype.names} for i in range(len(table))]
    begins = [d["begin"] for d in rects]
    seen = set()
    for lo in range(0, total, chunk):
        hi = min(lo + chunk, total)
        i = max(bisect.bisect_right(begins, lo) - 1, 0)
        while i < len(rects) and rects[i]["begin"] < hi:
            d = rects[i]
            i += 1
            end = d["begin"] + d["nbytes"]
            if lo >= end:
                continue
            x = max(lo - d["begin"], 0)
            y = min(hi, end) - d["begin"]
            g = d["grain"]
            assert x % g == 0 and y % g == 0
            upr = d["row_bytes"] // g
            walk = _emulate_wide_rows if upr >= threads else _emulate_narrow_rows
            walk(d, x // g, y // g, upr, g, threads, seen)
    assert len(seen) == sum(d["nbytes"] // d["grain"] for d in rects)


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
    assert table["ndim"][0] == 0
    # The main path's reshard rectangle: half the columns of each row.
    src = torch.zeros(2048, 8192, dtype=torch.bfloat16)
    dst = torch.zeros(2048, 16384, dtype=torch.bfloat16)[:, 8192:]
    table, total = kernels.rect_table([(src, dst)])
    assert len(table) == 1 and table["ndim"][0] == 1
    assert (table["rows"][0], table["row_bytes"][0]) == (2048, 16384)
    assert (table["src_stride"][0][0], table["dst_stride"][0][0]) == (16384, 32768)
    # A 4-D block merges where it can; one that no merge brings under
    # three dims is one descriptor of three dims outside its row.
    big = torch.zeros(3, 4, 5, 6)
    table, _ = kernels.rect_table([(big[:, :, :, :2], torch.zeros(3, 4, 5, 2))])
    assert len(table) == 1
    table, _ = kernels.rect_table([(big[:, :3, :, :2], torch.zeros(3, 3, 5, 2))])
    assert len(table) == 1
    table, _ = kernels.rect_table([(big[:, :3, :4, :2], torch.zeros(3, 3, 4, 2))])
    assert len(table) == 1 and table["ndim"][0] == 3 and table["rows"][0] == 36
    assert list(table["size"][0]) == [4, 3, 3, 0, 0]


def _rank_view(rank, strided_last, seed):
    """A (source view, destination) pair whose dims no merge reduces: a
    corner of a larger tensor, ``rank`` collapsed dims, the last one
    strided on both sides when ``strided_last``."""
    g = torch.Generator().manual_seed(seed)
    shape = [2, 3, 2, 3, 2, 3, 4][-rank:]
    big = torch.randn([n + 1 for n in shape], generator=g)
    src = big[tuple(slice(1, None) for _ in shape)]
    dst_base = torch.zeros([n + 2 for n in shape])
    dst = dst_base[tuple(slice(0, n) for n in shape)]
    if strided_last:
        src = src[..., ::2]
        dst = torch.zeros([n + 2 for n in shape])[tuple(slice(0, n) for n in shape)][..., 1::2]
    return src, dst


@pytest.mark.parametrize("strided_last", [False, True], ids=["row", "strided"])
@pytest.mark.parametrize("rank", [4, 5, 6, 7])
@pytest.mark.parametrize("threads", [kernels.K3_THREADS, 2])
def test_rect_table_ranks_four_to_six_emulated(rank, strided_last, threads):
    """Up to five collapsed dims outside the contiguous row (the row is one
    element when the last dim is strided) make one descriptor; a sixth
    cuts the view on its outermost dim, a seventh on its two outermost.
    Emulated at the kernel's block size and at 2 threads, where every row
    takes the segment walk."""
    src, dst = _rank_view(rank, strided_last, seed=rank)
    assert len(kernels._collapse(src.shape, src.stride(), dst.stride(), 4)) == rank
    want = dst.clone()
    want.copy_(src)
    table, total = kernels.rect_table([(src, dst)])
    outer = rank - (0 if strided_last else 1)
    cut = max(0, outer - kernels.K3_MAX_DIMS)
    assert len(table) == math.prod(src.shape[:cut])
    assert (table["begin"] % 16 == 0).all()
    assert (table["ndim"] == min(outer, kernels.K3_MAX_DIMS)).all()
    _emulate_copy_blocks(table, total, chunk=48, threads=threads)
    assert torch.equal(_bytes_of(dst), _bytes_of(want))


@pytest.mark.parametrize("case", _K3_CASES, ids=str)
@pytest.mark.parametrize("dtype", [t for t, _ in _PACKABLE], ids=str)
def test_copy_blocks_emulated_matches_reference_consumer(dtype, case):
    """K3's table, run by the emulator, fills a target exactly as the JAX
    package's consumer does (``np.copyto`` on its ``overlap``)."""
    np_dtype = dict(_PACKABLE)[dtype]
    src, dst, ov = _k3_inputs(np_dtype, case, seed=6)
    want = dst.copy()
    t_src, t_dst = _as_tensor(src), _as_tensor(dst)
    if ov is not None:
        src_sl, dst_sl = ov
        np.copyto(want[dst_sl] if dst_sl else want, src[src_sl] if src_sl else src, casting="no")
        table, total = kernels.rect_table([(t_src[ov[0]], t_dst[ov[1]])])
        _emulate_copy_blocks(table, total)
    np.testing.assert_array_equal(
        _bytes_of(t_dst).numpy(), np.ascontiguousarray(want).reshape(-1).view(np.uint8)
    )


@pytest.mark.parametrize("over", [0, 1], ids=["at_capacity", "one_over"])
def test_table_just_under_and_over_the_inline_parameter_size(over):
    """The largest table that fits the kernel's parameters goes by value;
    one descriptor more does not fit and is uploaded. Both tables run
    right under the emulator."""
    param_bytes = kernels.K3_PARAM_BYTES
    capacity = kernels.k3_inline_capacity()
    assert capacity == 151
    n = capacity + over
    base = torch.arange(4 * n * 24, dtype=torch.int16).reshape(n, 4, 24)
    out = torch.zeros(n, 4, 40, dtype=torch.int16)
    pairs = [(base[i, :, 3:21], out[i, :, 8:26]) for i in range(n)]
    table, total = kernels.rect_table(pairs)
    assert len(table) == n
    fits = 24 + table.nbytes <= param_bytes
    assert fits == (over == 0)
    _emulate_copy_blocks(table, total)
    for src, dst in pairs:
        assert torch.equal(src, dst)


@pytest.mark.parametrize(
    "total, chunk, blocks",
    [(0, 4096, 0), (4 << 20, 10592, 396), (32 << 30, 65536, 524288)],
    ids=["0B", "4MiB", "32GiB"],
)
def test_k3_chunk_rule(total, chunk, blocks):
    """About three blocks per SM of an H100 (132 SMs), the blocks the
    kernel keeps resident, 16-byte aligned, in [4 KiB, 64 KiB]."""
    got = kernels.k3_chunk_bytes(total, 132)
    assert got == chunk and got % 16 == 0
    assert -(-total // got) == blocks


@settings(max_examples=2000, deadline=None)
@given(n=st.integers(0, (1 << 32) - 1), d=st.integers(1, (1 << 32) - 1))
def test_fast_divmod_matches_divmod(n, d):
    mul, shift = kernels.fast_divmod_params(d)
    assert 0 <= mul < 1 << 32 and 0 <= shift <= 32
    q = kernels.fast_div(n, mul, shift)
    assert (q, n - q * d) == divmod(n, d)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 255, 256, 257, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 1])
def test_fast_divmod_at_the_edges(d):
    mul, shift = kernels.fast_divmod_params(d)
    for n in {0, 1, d - 1, d, d + 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 2, (1 << 32) - 1}:
        if 0 <= n < 1 << 32:
            assert kernels.fast_div(n, mul, shift) == n // d, (n, d)


def test_copy_blocks_checks_its_pairs():
    with pytest.raises(ValueError, match="does not match"):
        kernels.copy_blocks([(torch.zeros(2, 3), torch.zeros(3, 2))])
    with pytest.raises(ValueError, match="overlaps itself"):
        kernels.copy_blocks([(torch.zeros(4), torch.zeros(1).expand(4))])
    kernels.copy_blocks([])
