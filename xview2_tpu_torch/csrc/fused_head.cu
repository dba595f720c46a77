// Fused packed head: fold + LeakyReLU prologue, 1x1 GEMM, bias.
//
// Replaces the TPU kernel ops/packed_fused_conv.py::_head_kernel
// (_head_fwd_impl, reached through head_conv_fused).  Per pixel:
//   a   = prologue(x[p, :])                       (in T, see common.cuh)
//   acc = sum_c a[c] * kmat[c, o]                  (f32 accumulation)
//   out = T(T(acc) + T(hbias[o]))                  (two roundings, as in JAX)
//
// Bound on the H100: bytes.  On the main path x is (16, 512, 512, 128) bf16
// (1.07 GB) and the output (16, 512, 512, 8) bf16; the GEMM is 16 FLOP per
// byte of x, far below the card's ratio.  The design reads x once with
// coalesced 16-byte loads: a block stages a tile of TP whole pixels into
// shared memory, applying the prologue while staging, then each thread owns
// one pixel and walks its C channels against kmat, which sits in shared
// memory and is read as a broadcast.  The padded row stride keeps the
// per-pixel reads free of bank conflicts.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace xv;

constexpr int TP = 128;  // pixels per block == threads per block

template <typename T, int CO>
__global__ void __launch_bounds__(TP) head_kernel(
    const T* __restrict__ x, const float* __restrict__ kmat, const float* __restrict__ fold,
    const float* __restrict__ hbias, T* __restrict__ out, long long npix, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = c + 4 / sizeof(T);  // pad by one 32-bit word: conflict-free rows
  float* ks = reinterpret_cast<float*>(smem_raw);  // (c, CO)
  float* fs = ks + c * CO;                         // mean, mul, bias (3, c), rounded to T
  T* tile = reinterpret_cast<T*>(fs + 3 * c);      // (TP, ld)

  const int tid = threadIdx.x;
  for (int i = tid; i < c * CO; i += TP) ks[i] = rnd<T>(kmat[i]);
  for (int i = tid; i < 3 * c; i += TP) fs[i] = rnd<T>(fold[i]);
  const float slope = rnd<T>(kLeakySlope);
  __syncthreads();

  const long long p0 = (long long)blockIdx.x * TP;
  const int np = (int)min((long long)TP, npix - p0);
  // stage: 16-byte vectors of VEC elements, in source order (coalesced)
  constexpr int VEC = 16 / sizeof(T);
  const int vec_per_pix = c / VEC;
  const uint4* src = reinterpret_cast<const uint4*>(x + p0 * c);
  for (int v = tid; v < np * vec_per_pix; v += TP) {
    const int p = v / vec_per_pix;
    const int c0 = (v - p * vec_per_pix) * VEC;
    uint4 raw = src[v];
    const T* e = reinterpret_cast<const T*>(&raw);
    T* dst = tile + p * ld + c0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = c0 + k;
      dst[k] = from_float<T>(prologue<T>(to_float(e[k]), fs[ch], fs[c + ch], fs[2 * c + ch], slope));
    }
  }
  __syncthreads();

  if (tid >= np) return;
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;
  const T* row = tile + tid * ld;
  for (int k = 0; k < c; ++k) {
    const float a = to_float(row[k]);
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = fmaf(a, ks[k * CO + o], acc[o]);
  }
  T* dst = out + (p0 + tid) * CO;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const float y = rnd<T>(acc[o]);
    dst[o] = from_float<T>(__fadd_rn(y, rnd<T>(hbias[o])));
  }
}

template <typename T, int CO>
cudaError_t launch(const void* x, const float* kmat, const float* fold, const float* hbias,
                   void* out, long long npix, int c, cudaStream_t stream) {
  const size_t smem = (size_t)c * CO * 4 + 3 * (size_t)c * 4 +
                      (size_t)TP * (c + 4 / sizeof(T)) * sizeof(T);
  auto kern = head_kernel<T, CO>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (npix + TP - 1) / TP;
  if (blocks > 0)
    kern<<<(unsigned)blocks, TP, smem, stream>>>((const T*)x, kmat, fold, hbias, (T*)out, npix, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* kmat, const float* fold, const float* hbias,
                     void* out, long long npix, int c, int co, cudaStream_t s) {
  switch (co) {
    case 4: return launch<T, 4>(x, kmat, fold, hbias, out, npix, c, s);
    case 8: return launch<T, 8>(x, kmat, fold, hbias, out, npix, c, s);
    case 12: return launch<T, 12>(x, kmat, fold, hbias, out, npix, c, s);
    case 16: return launch<T, 16>(x, kmat, fold, hbias, out, npix, c, s);
    case 32: return launch<T, 32>(x, kmat, fold, hbias, out, npix, c, s);
    case 64: return launch<T, 64>(x, kmat, fold, hbias, out, npix, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (npix, c) contiguous T; kmat: (c, co) f32; fold: (3, c) f32 = mean, mul,
// bias; hbias: (co,) f32; out: (npix, co) contiguous T.  dtype 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int head_conv_fused(const void* x, const void* kmat, const void* fold,
                               const void* hbias, void* out, long long npix, int c, int co,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* k = (const float*)kmat;
  const float* f = (const float*)fold;
  const float* hb = (const float*)hbias;
  if (dtype == 0) return (int)dispatch<float>(x, k, f, hb, out, npix, c, co, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(x, k, f, hb, out, npix, c, co, s);
  return (int)cudaErrorInvalidValue;
}
