// Relayout copy: a strided tensor of rank <= 4 into a new contiguous
// (row-major) buffer.
//
// Replaces the TPU kernel ops/layout.py::_pallas_identity (_copy_kernel), which
// forces the eval logits and the train labels into a standard layout at the
// model/loss seam.  The copy is bit-exact: bytes are moved as raw words, never
// converted.
//
// Bound on the H100: bytes.  Each byte is read once and written once, so the
// least time is 2 * nbytes over the memory rate: 0.020 ms for the eval logits
// (4, 1024, 1024, 2) f32, 0.010 ms for each of the train step's three tensors
// (16.8 MB).  At the train size the card's time per call is of the order of
// the host's time to enqueue it, so the wrapper (ops/layout.py) keeps its own
// per-call work small: one bound entry point, scalar arguments, no arrays.
//
// Two paths, which the wrapper picks from the source's layout
// (layout.relayout_plan):
//  (a) relayout_flat: a contiguous source, which is every call on the main
//      paths.  A flat copy in words of the widest size (16 bytes at best) that
//      both pointers are aligned to, eight independent words in flight per
//      thread, one block of 256 threads per 2048 words (16 bytes a word: 32
//      KB); the tail that is no whole word is copied by bytes.
//  (b) relayout_strided: anything else, after dropping unit dims and merging
//      dims that are contiguous with each other.  One thread per destination
//      element in destination order (coalesced writes), reads following the
//      source strides, 32-bit index arithmetic whenever the tensor allows it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // independent words in flight per thread, path (a)

// ------------------------------------------------------------------ (a) flat
template <typename W>
__global__ void __launch_bounds__(THREADS)
    relayout_flat_kernel(const W* __restrict__ src, W* __restrict__ dst, long long n,
                         const unsigned char* __restrict__ src_tail,
                         unsigned char* __restrict__ dst_tail, int tail) {
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x; base < n;
       base += step) {
    W r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * THREADS < n) r[u] = src[base + u * THREADS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * THREADS < n) dst[base + u * THREADS] = r[u];
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

template <typename W>
cudaError_t launch_flat(const unsigned char* src, unsigned char* dst, long long nbytes,
                        cudaStream_t stream) {
  const long long n = nbytes / (long long)sizeof(W);
  const int tail = (int)(nbytes - n * (long long)sizeof(W));
  // one block per THREADS * UNROLL words: the card's scheduler balances the
  // blocks better than a persistent grid does (measured, kernel_ab.py)
  long long blocks = (n + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // then the blocks stride over the rest
  relayout_flat_kernel<W><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const W*)src, (W*)dst, n, src + n * sizeof(W), dst + n * sizeof(W), tail);
  return cudaGetLastError();
}

// -------------------------------------------------------------- (b) strided
template <typename Word, typename Index>
__global__ void __launch_bounds__(THREADS)
    relayout_strided_kernel(const Word* __restrict__ src, Word* __restrict__ dst, Index n,
                            Index d1, Index d2, Index d3, Index s0, Index s1, Index s2, Index s3) {
  const Index step = (Index)gridDim.x * blockDim.x;
  for (Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    Index r = i;
    const Index c = r % d3;
    r /= d3;
    const Index w = r % d2;
    r /= d2;
    const Index h = r % d1;
    const Index b = r / d1;
    dst[i] = src[b * s0 + h * s1 + w * s2 + c * s3];
  }
}

// dims and strides in elements
template <typename Word>
cudaError_t launch_strided(const void* src, void* dst, const long long* d, const long long* s,
                           cudaStream_t stream) {
  const long long n = d[0] * d[1] * d[2] * d[3];
  long long span = 1;  // largest source offset + 1
  for (int k = 0; k < 4; ++k) span += (d[k] - 1) * s[k];
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond ~64 blocks per SM
  if (n < (1LL << 31) && span < (1LL << 31)) {
    relayout_strided_kernel<Word, uint32_t><<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const Word*)src, (Word*)dst, (uint32_t)n, (uint32_t)d[1], (uint32_t)d[2],
        (uint32_t)d[3], (uint32_t)s[0], (uint32_t)s[1], (uint32_t)s[2], (uint32_t)s[3]);
  } else {
    relayout_strided_kernel<Word, long long><<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const Word*)src, (Word*)dst, n, d[1], d[2], d[3], s[0], s[1], s[2], s[3]);
  }
  return cudaGetLastError();
}

}  // namespace

// Path (a): nbytes of a contiguous source into dst.  Returns the
// cudaError_t of the launch (0 on success); nbytes == 0 launches nothing.
extern "C" int relayout_flat(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* a = (const unsigned char*)src;
  unsigned char* b = (unsigned char*)dst;
  const uintptr_t align = ((uintptr_t)src | (uintptr_t)dst | 16u);
  switch (align & (~align + 1)) {  // the widest word both pointers are aligned to
    case 16: return (int)launch_flat<uint4>(a, b, nbytes, s);
    case 8: return (int)launch_flat<uint2>(a, b, nbytes, s);
    case 4: return (int)launch_flat<uint32_t>(a, b, nbytes, s);
    case 2: return (int)launch_flat<uint16_t>(a, b, nbytes, s);
    default: return (int)launch_flat<uint8_t>(a, b, nbytes, s);
  }
}

// Path (b): dims d0..d3 and strides s0..s3 (in elements) of the merged source
// view, as layout.relayout_plan gives them, into a contiguous destination
// with the same dims.  Returns the cudaError_t of the launch.
extern "C" int relayout_strided(const void* src, void* dst, int itemsize, long long d0,
                                long long d1, long long d2, long long d3, long long s0,
                                long long s1, long long s2, long long s3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long d[4] = {d0, d1, d2, d3}, st[4] = {s0, s1, s2, s3};
  if (d0 * d1 * d2 * d3 <= 0) return 0;
  switch (itemsize) {
    case 1: return (int)launch_strided<uint8_t>(src, dst, d, st, s);
    case 2: return (int)launch_strided<uint16_t>(src, dst, d, st, s);
    case 4: return (int)launch_strided<uint32_t>(src, dst, d, st, s);
    case 8: return (int)launch_strided<uint64_t>(src, dst, d, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
