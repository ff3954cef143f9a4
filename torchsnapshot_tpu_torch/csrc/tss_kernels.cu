// Hand-written Hopper (sm_90a) kernels of torchsnapshot_tpu_torch.
//
// All three kernels are multi-tensor byte copies driven by a descriptor
// table built by the Python wrapper (kernels.py):
//
//   K1  tss_pack_slab  replaces torchsnapshot_tpu/batcher.py::_pack_to_device_bytes
//       (the jitted bitcast-to-uint8 + concatenate of a slab's members).
//       Gathers N member tensors' raw little-endian C-order bytes into one
//       uint8 slab: descriptor i copies member i to slab + offset_i.
//   K2  tss_fork_copy  replaces torchsnapshot_tpu/io_preparer.py::_batch_copy_fn
//       (the jitted [jnp.copy(x) for x in xs] of the async_take fork).
//       Bitwise-copies every tensor of a group into a fresh tensor.
//   K3  tss_copy_blocks  replaces the overlap scatter of
//       torchsnapshot_tpu/io_preparers/sharded_array.py:266-323
//       (ShardedArrayBufferConsumer.consume_buffer, _shard_piece_deliver:
//       np.copyto(dst[dst_slices], src[src_slices]) on the host, then
//       make_array_from_callback). Copies a table of strided byte
//       rectangles of up to five dims each (see below), on one device.
//
// Bound: all three are pure copies. Each byte is read once and written once, so
// the least time on an H100 SXM is 2 * bytes / 3.35 TB/s (bytes-bound; no
// arithmetic). The design serves that bound:
//   - One launch covers every member, so a slab of thousands of small
//     tensors pays one launch instead of thousands.
//   - The members are laid end to end in a virtual byte space (desc.begin is
//     each member's prefix offset). Block b owns the fixed range
//     [b * chunk, (b + 1) * chunk) of that space and finds its first member
//     by binary search, so large and tiny members share the grid evenly and
//     the table stays O(members), not O(chunks).
//   - Within a member, K1 and K2 use 16-byte vector loads and stores when
//     source and destination share their alignment mod 16 (the common
//     case: allocations are 512-byte aligned and slab offsets of
//     16-byte-multiple members stay aligned), after a short byte head. When
//     they differ they fall back to the widest common grain (8, 4, 2, 1).
//     K1 and K2 cut the space into fixed 64 KiB chunks.
//
// K3's rectangles. The wrapper merges the dims of a (source view,
// destination view) pair that are contiguous on both sides, and one
// descriptor (TssRect) then holds the whole rectangle: a contiguous row of
// row_bytes bytes (one element when the last dim is strided) and up to
// kMaxDims = 5 dims outside it, each with its size, source byte stride and
// destination byte stride, innermost first. A view that keeps more than five
// dims outside its row is cut on its outermost dims only, one descriptor
// per index of those. The wrapper also stores the rectangle's grain (the widest of 16,
// 8, 4, 2, 1 bytes dividing both base addresses, the row and every stride)
// and, per dim, a 32-bit fast-divmod multiplier and shift, so that a row
// index splits into the dims' indices by multiplies and shifts, with no
// division. Begins are rounded up to 16 bytes in the virtual byte space.
//
// K3's grid is sized to the card: the wrapper reads the SM count once per
// device and passes chunk = clamp(round_up_16(ceil(total / (3 * SMs))),
// 4 KiB, 64 KiB) (kernels.k3_chunk_bytes), so a 4 MiB copy gets 396 blocks
// of 256 threads on an H100's 132 SMs, not 64: one wave, since the kernel
// is built to keep kK3MinBlocks = 3 blocks resident per SM (at most 85
// registers a thread). Copies from ~25 MiB up keep 64 KiB chunks. Both 3s
// were tuned on the card against 2 and 4 (PERF.md). Each block copies its
// share of each rectangle in grain units, two ways:
//   - Rows of fewer units than the block has threads (narrow rows: a
//     128-byte row of a permuted attention head is 8 units) go to lane
//     groups of min(32, next_pow2(units)) lanes, one row per group at a
//     time, so a warp copies 4 rows of 8 units at once. A group finds its
//     row's two addresses once, by the fast divmods (32-bit indices when the
//     rectangle has under 2^32 rows; a table holding a rectangle of more is
//     uploaded and runs a second instance of the kernel that divides in 64
//     bits). The dims are staged in shared memory per rectangle, so that
//     they take no registers across the copy loops.
//   - Rows of at least a block's worth of units are streamed: thread t
//     copies units t, t + 256, ... of the block's share, crossing row
//     ends by adds (a step of 256 units crosses at most one).
// Either way each thread issues kUnroll = 4 independent loads before their
// stores, so enough bytes are in flight to cover the memory latency
// (about 3.35 TB/s x 0.6 us, 2 MB across the card). Measured on an H100,
// the narrow-row shapes (a 4 MiB rank-4 rectangle of 128-byte rows, the
// gather of a permuted attention tensor) run within twice their bound on
// this path, so K3 has no TMA path.
//
// K3's table reaches the kernel by value, as a __grid_constant__ kernel
// parameter, when it fits (kInlineMax descriptors: 32,764 bytes of
// parameters on sm_90, which needs CUDA 12.1 or later to build), so a call
// costs one launch and no copy; a larger table is uploaded by the wrapper
// from a pinned buffer it reuses, and the kernel reads it from device memory.
//
// Launch discipline: each entry launches on the stream it is given, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

struct TssCopyDesc {
  const unsigned char* src;
  unsigned char* dst;
  unsigned long long begin;   // prefix offset of this member in the virtual byte space
  unsigned long long nbytes;  // > 0 (the wrapper drops empty members)
};

template <typename T>
__device__ __forceinline__ void copy_grain(const unsigned char* src, unsigned char* dst,
                                           unsigned long long n) {
  // Byte head until dst is aligned to sizeof(T); src shares the alignment.
  unsigned long long head = (sizeof(T) - (reinterpret_cast<uintptr_t>(dst) & (sizeof(T) - 1))) &
                            (sizeof(T) - 1);
  if (head > n) head = n;
  for (unsigned long long i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  unsigned long long body = (n - head) / sizeof(T);
  const T* s = reinterpret_cast<const T*>(src + head);
  T* d = reinterpret_cast<T*>(dst + head);
  for (unsigned long long i = threadIdx.x; i < body; i += blockDim.x) d[i] = s[i];
  unsigned long long tail0 = head + body * sizeof(T);
  for (unsigned long long i = tail0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void copy_range(const unsigned char* src, unsigned char* dst,
                                           unsigned long long n) {
  uintptr_t mis = reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst);
  if ((mis & 15) == 0) {
    copy_grain<uint4>(src, dst, n);
  } else if ((mis & 7) == 0) {
    copy_grain<unsigned long long>(src, dst, n);
  } else if ((mis & 3) == 0) {
    copy_grain<unsigned int>(src, dst, n);
  } else if ((mis & 1) == 0) {
    copy_grain<unsigned short>(src, dst, n);
  } else {
    copy_grain<unsigned char>(src, dst, n);
  }
}

__device__ __forceinline__ void copy_block_range(const TssCopyDesc* __restrict__ descs, int ndesc,
                                                 unsigned long long total,
                                                 unsigned long long chunk) {
  unsigned long long lo = static_cast<unsigned long long>(blockIdx.x) * chunk;
  unsigned long long hi = lo + chunk < total ? lo + chunk : total;
  // Last descriptor whose begin <= lo.
  int a = 0, b = ndesc - 1;
  while (a < b) {
    int mid = (a + b + 1) / 2;
    if (descs[mid].begin <= lo) a = mid; else b = mid - 1;
  }
  for (int i = a; i < ndesc && descs[i].begin < hi; ++i) {
    unsigned long long mb = descs[i].begin;
    unsigned long long me = mb + descs[i].nbytes;
    unsigned long long x = lo > mb ? lo : mb;
    unsigned long long y = hi < me ? hi : me;
    if (x < y) copy_range(descs[i].src + (x - mb), descs[i].dst + (x - mb), y - x);
  }
}

__global__ void tss_pack_slab_kernel(const TssCopyDesc* __restrict__ descs, int ndesc,
                                     unsigned long long total, unsigned long long chunk) {
  copy_block_range(descs, ndesc, total, chunk);
}

__global__ void tss_fork_copy_kernel(const TssCopyDesc* __restrict__ descs, int ndesc,
                                     unsigned long long total, unsigned long long chunk) {
  copy_block_range(descs, ndesc, total, chunk);
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

static constexpr int kMaxDims = 5;   // dims outside the row in one descriptor
static constexpr int kK3Threads = 256;
static constexpr int kK3MinBlocks = 3;  // resident blocks per SM (kernels.K3_BLOCKS_PER_SM)
static constexpr int kUnroll = 4;    // independent loads per thread before their stores

// One rectangle (kernels.py: _RECT_DTYPE, the same 216 bytes).
struct TssRect {
  unsigned long long src;           // base addresses
  unsigned long long dst;
  unsigned long long begin;         // 16-byte aligned offset in the virtual byte space
  unsigned long long nbytes;        // rows * row_bytes > 0
  unsigned long long row_bytes;     // contiguous bytes per row, a multiple of grain
  unsigned long long rows;          // product of size[0 .. ndim)
  unsigned long long size[kMaxDims];        // dims outside the row, innermost first
  unsigned long long src_stride[kMaxDims];  // bytes
  unsigned long long dst_stride[kMaxDims];
  unsigned int mul[kMaxDims];       // fast divmod by size[k] (used when rows < 2^32)
  unsigned int shift[kMaxDims];
  unsigned int ndim;                // 0 .. kMaxDims
  unsigned int grain;               // 16, 8, 4, 2 or 1
};

// n / d for n < 2^32 by the round-up method (Granlund and Montgomery):
// mul = floor(2^32 (2^shift - d) / d) + 1 with shift = ceil(log2 d), the
// sum taken in 64 bits so that it is exact over all 32-bit n and d >= 1.
__device__ __forceinline__ unsigned int fast_div(unsigned int n, unsigned int mul,
                                                 unsigned int shift) {
  return static_cast<unsigned int>(
      (static_cast<unsigned long long>(__umulhi(n, mul)) + n) >> shift);
}

// The rectangle a block is on, staged in shared memory: its dims, and its
// share's first row and column, last row and count of units (one thread
// divides, once). Read through a volatile reference, so that the dims are
// not held in registers across the copy loops (which would cost occupancy).
struct TssStage {
  unsigned long long src_stride[kMaxDims];
  unsigned long long dst_stride[kMaxDims];
  unsigned long long size[kMaxDims];
  unsigned int mul[kMaxDims];
  unsigned int shift[kMaxDims];
  unsigned int ndim;
  unsigned int n;  // units in the share: at most chunk / grain, under 2^31
  unsigned long long r0, c0, rb;
};

// Source and destination byte offsets of row r: fast divmods by the dims'
// sizes, innermost first, in 32 bits; 64-bit division in the kernel for
// rectangles of 2^32 rows or more (I = unsigned long long).
template <typename I>
__device__ __forceinline__ void row_offsets(const volatile TssStage& m, I r,
                                            unsigned long long& so, unsigned long long& dso) {
  so = 0;
  dso = 0;
  const int nd = static_cast<int>(m.ndim);
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    if (k >= nd) break;
    I i;
    if (k + 1 == nd) {
      i = r;  // the outermost dim takes what is left
    } else if (sizeof(I) == 8) {
      const I n = static_cast<I>(m.size[k]);
      const I q = r / n;
      i = r - q * n;
      r = q;
    } else {
      const unsigned int q = fast_div(static_cast<unsigned int>(r), m.mul[k], m.shift[k]);
      i = static_cast<I>(r - q * static_cast<unsigned int>(m.size[k]));
      r = q;
    }
    so += static_cast<unsigned long long>(i) * m.src_stride[k];
    dso += static_cast<unsigned long long>(i) * m.dst_stride[k];
  }
}

// The share of a rectangle whose rows hold at least a block's worth of
// units (upr): the block streams it as one run of units, thread t on units
// t, t + threads, ... of it; a step of a block's worth crosses at most one
// row end, so each thread tracks its row and column by adds.
template <typename T, typename I>
__device__ __forceinline__ void copy_wide_rows(const unsigned char* src, unsigned char* dst,
                                               const volatile TssStage& m, I upr) {
  const unsigned int n = m.n;
  I r = static_cast<I>(m.r0);
  I c = static_cast<I>(m.c0) + threadIdx.x;
  if (c >= upr) {
    c -= upr;
    ++r;
  }
  I cur = ~static_cast<I>(0);
  unsigned long long so = 0, dso = 0;
  for (unsigned int t = threadIdx.x; t < n;) {
    T v[kUnroll];
    T* out[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      out[k] = nullptr;
      if (t < n) {
        if (r != cur) {
          row_offsets<I>(m, r, so, dso);
          cur = r;
        }
        v[k] = *(reinterpret_cast<const T*>(src + so) + c);
        out[k] = reinterpret_cast<T*>(dst + dso) + c;
      }
      t += kK3Threads;
      c += kK3Threads;
      if (c >= upr) {
        c -= upr;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (out[k] != nullptr) *out[k] = v[k];
    }
  }
}

// The share of a rectangle whose rows hold fewer units (up) than the block
// has threads: lane groups of L = min(32, next_pow2(up)) lanes, one row
// per group at a time, each lane on units lane, lane + L, ... of the row.
// A group's items (row, column step) run rows rr, rr + groups, ... of the
// share (rr counted from its first row); each thread gathers kUnroll
// items' loads before it stores them.
template <typename T, typename I>
__device__ __forceinline__ void copy_narrow_rows(const unsigned char* src, unsigned char* dst,
                                                 const volatile TssStage& m, unsigned int up) {
  const unsigned int lg = up >= 32u ? 5u : (up <= 1u ? 0u : 32u - __clz(up - 1u));
  const unsigned int lane = threadIdx.x & ((1u << lg) - 1u);
  const unsigned int groups = kK3Threads >> lg;
  const unsigned int csteps = (up + (1u << lg) - 1u) >> lg;
  const I r0 = static_cast<I>(m.r0);
  const unsigned int c0 = static_cast<unsigned int>(m.c0);
  const unsigned int c1 = c0 + m.n;  // the share is units [c0, c1) from row r0's start
  const unsigned int last = static_cast<unsigned int>(m.rb - m.r0);
  unsigned int rr = threadIdx.x >> lg;
  unsigned int j = 0;
  I cur = ~static_cast<I>(0);
  unsigned long long so = 0, dso = 0;
  while (rr <= last) {
    T v[kUnroll];
    T* out[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      out[k] = nullptr;
      if (rr <= last) {
        const unsigned int c = lane + (j << lg);
        const unsigned int p = rr * up + c;
        if (c < up && p >= c0 && p < c1) {
          const I r = r0 + rr;
          if (r != cur) {
            row_offsets<I>(m, r, so, dso);
            cur = r;
          }
          v[k] = *(reinterpret_cast<const T*>(src + so) + c);
          out[k] = reinterpret_cast<T*>(dst + dso) + c;
        }
        if (++j == csteps) {
          j = 0;
          rr += groups;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (out[k] != nullptr) *out[k] = v[k];
    }
  }
}

template <typename T, typename I>
__device__ __forceinline__ void copy_rect(const TssRect& d, const volatile TssStage& m,
                                          unsigned long long upr) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(d.src);
  unsigned char* dst = reinterpret_cast<unsigned char*>(d.dst);
  if (upr >= static_cast<unsigned long long>(kK3Threads)) {
    copy_wide_rows<T, I>(src, dst, m, static_cast<I>(upr));
  } else {
    copy_narrow_rows<T, I>(src, dst, m, static_cast<unsigned int>(upr));
  }
}

// Block b copies bytes [b * chunk, (b + 1) * chunk) of the virtual space.
// I is unsigned int for tables whose rectangles all have under 2^32 rows
// and under 2^31 units a row, else unsigned long long.
template <typename I>
__device__ __forceinline__ void copy_blocks_body(const TssRect* __restrict__ descs, int ndesc,
                                                 unsigned long long total,
                                                 unsigned long long chunk) {
  __shared__ TssStage stage;
  volatile TssStage& m = stage;
  const unsigned long long lo = static_cast<unsigned long long>(blockIdx.x) * chunk;
  const unsigned long long hi = lo + chunk < total ? lo + chunk : total;
  int a = 0, b = ndesc - 1;
  while (a < b) {
    int mid = (a + b + 1) / 2;
    if (descs[mid].begin <= lo) a = mid; else b = mid - 1;
  }
  for (int i = a; i < ndesc && descs[i].begin < hi; ++i) {
    const TssRect& d = descs[i];
    const unsigned long long end = d.begin + d.nbytes;
    if (lo >= end) continue;  // the same for the whole block
    const unsigned int lg = __ffs(d.grain) - 1;
    const unsigned long long upr = d.row_bytes >> lg;
    __syncthreads();  // the previous rectangle's readers are done
    if (threadIdx.x < kMaxDims) {
      const int k = threadIdx.x;
      m.src_stride[k] = d.src_stride[k];
      m.dst_stride[k] = d.dst_stride[k];
      m.size[k] = d.size[k];
      m.mul[k] = d.mul[k];
      m.shift[k] = d.shift[k];
    } else if (threadIdx.x == kMaxDims) {
      const unsigned long long u0 = (lo > d.begin ? lo - d.begin : 0) >> lg;
      const unsigned long long u1 = ((hi < end ? hi : end) - d.begin) >> lg;
      const unsigned long long r0 = u0 / upr;
      m.ndim = d.ndim;
      m.n = static_cast<unsigned int>(u1 - u0);
      m.r0 = r0;
      m.c0 = u0 - r0 * upr;
      m.rb = (u1 - 1) / upr;
    }
    __syncthreads();
    switch (lg) {
      case 4: copy_rect<uint4, I>(d, m, upr); break;
      case 3: copy_rect<unsigned long long, I>(d, m, upr); break;
      case 2: copy_rect<unsigned int, I>(d, m, upr); break;
      case 1: copy_rect<unsigned short, I>(d, m, upr); break;
      default: copy_rect<unsigned char, I>(d, m, upr); break;
    }
  }
}

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "K3 passes its table as a 32,764-byte kernel parameter, which needs CUDA 12.1 or later"
#endif
static constexpr int kParamBytes = 32764;  // kernel parameters on sm_90

// The table as a kernel parameter: a header and up to CAP descriptors.
template <int CAP>
struct TssRectTable {
  unsigned long long total;
  unsigned long long chunk;
  int ndesc;
  int pad;
  TssRect d[CAP];
};

static constexpr int kInlineMax =
    static_cast<int>((kParamBytes - sizeof(TssRectTable<1>) + sizeof(TssRect)) / sizeof(TssRect));
static_assert(sizeof(TssRect) == 216, "TssRect layout changed: update kernels.py");
static_assert(sizeof(TssRectTable<kInlineMax>) <= kParamBytes, "inline table too large");

template <int CAP>
__global__ void __launch_bounds__(kK3Threads, kK3MinBlocks)
    tss_copy_blocks_inline_kernel(const __grid_constant__ TssRectTable<CAP> t) {
  copy_blocks_body<unsigned int>(t.d, t.ndesc, t.total, t.chunk);
}

template <bool kBig>
__global__ void __launch_bounds__(kK3Threads, kK3MinBlocks)
    tss_copy_blocks_kernel(const TssRect* __restrict__ descs, int ndesc, unsigned long long total,
                           unsigned long long chunk) {
  copy_blocks_body<typename std::conditional<kBig, unsigned long long, unsigned int>::type>(
      descs, ndesc, total, chunk);
}

template <int CAP>
static void launch_inline(const TssRect* host, int ndesc, unsigned long long total,
                          unsigned long long chunk, unsigned int blocks, cudaStream_t s) {
  TssRectTable<CAP> t;
  t.total = total;
  t.chunk = chunk;
  t.ndesc = ndesc;
  t.pad = 0;
  memcpy(t.d, host, static_cast<size_t>(ndesc) * sizeof(TssRect));
  tss_copy_blocks_inline_kernel<CAP><<<blocks, kK3Threads, 0, s>>>(t);
}

__global__ void tss_empty_kernel() {}

static const int kNeedsDeviceTable = -1;  // kernels.py: _K3_NEEDS_DEVICE_TABLE

static const unsigned long long kChunkBytes = 64ull * 1024ull;
static const int kThreads = 256;

static int launch(bool pack, const void* descs, int ndesc, unsigned long long total,
                  void* stream) {
  if (ndesc <= 0 || total == 0) return 0;
  unsigned long long blocks = (total + kChunkBytes - 1) / kChunkBytes;
  if (blocks > 0x7fffffffull) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TssCopyDesc* d = static_cast<const TssCopyDesc*>(descs);
  if (pack) {
    tss_pack_slab_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(d, ndesc, total,
                                                                                kChunkBytes);
  } else {
    tss_fork_copy_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(d, ndesc, total,
                                                                                kChunkBytes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// descs: device pointer to ndesc TssCopyDesc; total: sum of nbytes.
int tss_pack_slab(const void* descs, int ndesc, unsigned long long total, void* stream) {
  return launch(true, descs, ndesc, total, stream);
}

int tss_fork_copy(const void* descs, int ndesc, unsigned long long total, void* stream) {
  return launch(false, descs, ndesc, total, stream);
}

// host_table: ndesc TssRect in host memory, sorted by begin; total: the end
// of the last rectangle in the virtual byte space; chunk: bytes per block,
// a multiple of 16 under 2^31 (kernels.k3_chunk_bytes). With device_table
// null the table goes by value; a table that cannot (more than
// tss_copy_blocks_inline_max() descriptors, or a rectangle of 2^32 rows or
// 2^31 units a row or more) launches nothing and returns kNeedsDeviceTable.
// Otherwise device_table holds the same descriptors in device memory.
int tss_copy_blocks(const void* host_table, int ndesc, const void* device_table,
                    unsigned long long total, unsigned long long chunk, void* stream) {
  if (ndesc <= 0 || total == 0) return 0;
  if (chunk == 0 || (chunk & 15) != 0 || chunk > 0x7fffffffull) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long blocks = (total + chunk - 1) / chunk;
  if (blocks > 0x7fffffffull) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int nb = static_cast<unsigned int>(blocks);
  const TssRect* host = static_cast<const TssRect*>(host_table);
  bool big = false;
  for (int i = 0; i < ndesc; ++i) {
    big = big || host[i].rows > 0xffffffffull || host[i].row_bytes / host[i].grain > 0x7fffffffull;
  }
  if (device_table != nullptr) {
    const TssRect* dev = static_cast<const TssRect*>(device_table);
    if (big) {
      tss_copy_blocks_kernel<true><<<nb, kK3Threads, 0, s>>>(dev, ndesc, total, chunk);
    } else {
      tss_copy_blocks_kernel<false><<<nb, kK3Threads, 0, s>>>(dev, ndesc, total, chunk);
    }
  } else if (big || ndesc > kInlineMax) {
    return kNeedsDeviceTable;  // nothing launched: the wrapper uploads the table
  } else if (ndesc == 1) {
    launch_inline<1>(host, ndesc, total, chunk, nb, s);
  } else {
    launch_inline<kInlineMax>(host, ndesc, total, chunk, nb, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int tss_copy_blocks_inline_max() { return kInlineMax; }

// One empty launch on the stream: the floor under any kernel's time.
int tss_empty(void* stream) {
  tss_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int tss_desc_size() { return static_cast<int>(sizeof(TssCopyDesc)); }

int tss_rect_desc_size() { return static_cast<int>(sizeof(TssRect)); }

}  // extern "C"
