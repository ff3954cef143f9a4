// Hand-written Hopper (sm_90a) kernels of torchsnapshot_tpu_torch.
//
// All three kernels are multi-tensor byte copies driven by one device-side
// descriptor table, built by the Python wrapper (kernels.py):
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
//       rectangles, up to three dims each (see below), on one device.
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
//   - Within a member, the copy uses 16-byte vector loads and stores when
//     source and destination share their alignment mod 16 (the common
//     case: allocations are 512-byte aligned and slab offsets of
//     16-byte-multiple members stay aligned), after a short byte head. When
//     they differ it falls back to the widest common grain (8, 4, 2, 1).
//
// K3's rectangles. The wrapper merges the dims of a (source view,
// destination view) pair that are contiguous on both sides, so an N-d
// overlap of two C-order blocks becomes at most three dims: `outer` planes
// of `rows` rows of `row_bytes` bytes, with a row pitch and a plane pitch
// on each side (a view whose last dim is strided gets rows of one
// element). Each rectangle occupies [begin, begin + nbytes) of the virtual
// byte space; begins are rounded up to 16 bytes, so a block's share of a
// rectangle starts 16-byte aligned. The wrapper also stores the rectangle's
// grain: the widest of 16, 8, 4, 2, 1 bytes dividing both base addresses,
// the row length and all four pitches. Each block then copies its share in
// units of that grain: row segment by row segment, all threads on one
// segment, when a row holds at least a block's worth of units; unit by
// unit, each thread locating its own row, when rows are narrower.
//
// Launch discipline: each entry launches on the stream it is given, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

struct TssRectDesc {
  const unsigned char* src;
  unsigned char* dst;
  unsigned long long begin;       // 16-byte aligned offset in the virtual byte space
  unsigned long long nbytes;      // outer * rows * row_bytes > 0
  unsigned long long row_bytes;
  unsigned long long rows;
  unsigned long long src_pitch;   // bytes between rows
  unsigned long long dst_pitch;
  unsigned long long src_opitch;  // bytes between planes
  unsigned long long dst_opitch;
  unsigned long long grain;       // 16, 8, 4, 2 or 1
};

template <typename T>
__device__ __forceinline__ void copy_rect(const TssRectDesc& d, unsigned long long x,
                                          unsigned long long y) {
  const unsigned long long upr = d.row_bytes / sizeof(T);  // units per row
  const unsigned long long plane = upr * d.rows;
  const unsigned long long u1 = y / sizeof(T);
  if (upr >= blockDim.x) {
    unsigned long long u = x / sizeof(T);
    while (u < u1) {
      unsigned long long o = u / plane;
      unsigned long long rem = u - o * plane;
      unsigned long long r = rem / upr;
      unsigned long long c = rem - r * upr;
      unsigned long long n = upr - c < u1 - u ? upr - c : u1 - u;
      const T* s = reinterpret_cast<const T*>(d.src + o * d.src_opitch + r * d.src_pitch) + c;
      T* t = reinterpret_cast<T*>(d.dst + o * d.dst_opitch + r * d.dst_pitch) + c;
      for (unsigned long long j = threadIdx.x; j < n; j += blockDim.x) t[j] = s[j];
      u += n;
    }
  } else {
    for (unsigned long long u = x / sizeof(T) + threadIdx.x; u < u1; u += blockDim.x) {
      unsigned long long o = u / plane;
      unsigned long long rem = u - o * plane;
      unsigned long long r = rem / upr;
      unsigned long long c = rem - r * upr;
      *(reinterpret_cast<T*>(d.dst + o * d.dst_opitch + r * d.dst_pitch) + c) =
          *(reinterpret_cast<const T*>(d.src + o * d.src_opitch + r * d.src_pitch) + c);
    }
  }
}

__global__ void tss_copy_blocks_kernel(const TssRectDesc* __restrict__ descs, int ndesc,
                                       unsigned long long total, unsigned long long chunk) {
  unsigned long long lo = static_cast<unsigned long long>(blockIdx.x) * chunk;
  unsigned long long hi = lo + chunk < total ? lo + chunk : total;
  int a = 0, b = ndesc - 1;
  while (a < b) {
    int mid = (a + b + 1) / 2;
    if (descs[mid].begin <= lo) a = mid; else b = mid - 1;
  }
  for (int i = a; i < ndesc && descs[i].begin < hi; ++i) {
    const TssRectDesc d = descs[i];
    unsigned long long x = lo > d.begin ? lo - d.begin : 0;
    unsigned long long end = d.begin + d.nbytes;
    unsigned long long y = (hi < end ? hi : end) - d.begin;
    if (d.begin + x >= end || x >= y) continue;
    switch (d.grain) {
      case 16: copy_rect<uint4>(d, x, y); break;
      case 8: copy_rect<unsigned long long>(d, x, y); break;
      case 4: copy_rect<unsigned int>(d, x, y); break;
      case 2: copy_rect<unsigned short>(d, x, y); break;
      default: copy_rect<unsigned char>(d, x, y); break;
    }
  }
}

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

// descs: device pointer to ndesc TssRectDesc sorted by begin; total: the
// end of the last rectangle in the virtual byte space.
int tss_copy_blocks(const void* descs, int ndesc, unsigned long long total, void* stream) {
  if (ndesc <= 0 || total == 0) return 0;
  unsigned long long blocks = (total + kChunkBytes - 1) / kChunkBytes;
  if (blocks > 0x7fffffffull) return static_cast<int>(cudaErrorInvalidValue);
  tss_copy_blocks_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TssRectDesc*>(descs), ndesc, total, kChunkBytes);
  return static_cast<int>(cudaGetLastError());
}

int tss_desc_size() { return static_cast<int>(sizeof(TssCopyDesc)); }

int tss_rect_desc_size() { return static_cast<int>(sizeof(TssRectDesc)); }

}  // extern "C"
