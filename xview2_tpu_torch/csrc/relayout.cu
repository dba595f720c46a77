// Relayout copy: a strided 4-D tensor into a new contiguous (row-major) buffer.
//
// Replaces the TPU kernel ops/layout.py::_pallas_identity (_copy_kernel), which
// forces the eval logits and the train labels into a standard layout at the
// model/loss seam.  The copy is bit-exact: elements are moved as raw 1/2/4/8
// byte words, never converted.
//
// Bound on the H100: bytes.  Each element is read once and written once, so
// the least time is 2 * numel * itemsize over the memory rate.  The design
// keeps the writes fully coalesced (one thread per destination element, in
// destination order) and lets the reads follow the source strides; the index
// arithmetic runs in 32-bit integers whenever the tensor allows it, so the
// divisions do not dominate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Word, typename Index>
__global__ void relayout_kernel(const Word* __restrict__ src, Word* __restrict__ dst,
                                Index n, Index d1, Index d2, Index d3,
                                Index s0, Index s1, Index s2, Index s3) {
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

template <typename Word>
cudaError_t launch(const void* src, void* dst, const long long* dims, const long long* strides,
                   cudaStream_t stream) {
  const long long n = dims[0] * dims[1] * dims[2] * dims[3];
  if (n == 0) return cudaSuccess;
  long long span = 1;  // largest source offset + 1
  for (int k = 0; k < 4; ++k) span += (dims[k] - 1) * strides[k];
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond ~64 blocks per SM
  if (n < (1LL << 31) && span < (1LL << 31)) {
    relayout_kernel<Word, uint32_t><<<(unsigned)blocks, threads, 0, stream>>>(
        (const Word*)src, (Word*)dst, (uint32_t)n, (uint32_t)dims[1], (uint32_t)dims[2],
        (uint32_t)dims[3], (uint32_t)strides[0], (uint32_t)strides[1], (uint32_t)strides[2],
        (uint32_t)strides[3]);
  } else {
    relayout_kernel<Word, long long><<<(unsigned)blocks, threads, 0, stream>>>(
        (const Word*)src, (Word*)dst, n, dims[1], dims[2], dims[3], strides[0], strides[1],
        strides[2], strides[3]);
  }
  return cudaGetLastError();
}

}  // namespace

// dims and strides (in elements) of the source, 4 entries each; the
// destination is contiguous with the same dims.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int relayout_copy(const void* src, void* dst, int itemsize, const long long* dims,
                             const long long* strides, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (itemsize) {
    case 1: return (int)launch<uint8_t>(src, dst, dims, strides, s);
    case 2: return (int)launch<uint16_t>(src, dst, dims, strides, s);
    case 4: return (int)launch<uint32_t>(src, dst, dims, strides, s);
    case 8: return (int)launch<uint64_t>(src, dst, dims, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
