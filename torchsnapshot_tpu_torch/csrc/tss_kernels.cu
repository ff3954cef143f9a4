// Hand-written Hopper (sm_90a) kernels of torchsnapshot_tpu_torch.
//
// Both kernels are multi-tensor byte copies driven by one device-side
// descriptor table, built by the Python wrapper (kernels.py):
//
//   K1  tss_pack_slab  replaces torchsnapshot_tpu/batcher.py::_pack_to_device_bytes
//       (the jitted bitcast-to-uint8 + concatenate of a slab's members).
//       Gathers N member tensors' raw little-endian C-order bytes into one
//       uint8 slab: descriptor i copies member i to slab + offset_i.
//   K2  tss_fork_copy  replaces torchsnapshot_tpu/io_preparer.py::_batch_copy_fn
//       (the jitted [jnp.copy(x) for x in xs] of the async_take fork).
//       Bitwise-copies every tensor of a group into a fresh tensor.
//
// Bound: both are pure copies. Each byte is read once and written once, so
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

int tss_desc_size() { return static_cast<int>(sizeof(TssCopyDesc)); }

}  // extern "C"
