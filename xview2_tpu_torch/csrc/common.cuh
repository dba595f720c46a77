// Shared device helpers of the fused conv+BN and fused head kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace xv {

constexpr float kLeakySlope = 0.01f;

// Round a float to the storage type T and back: the rounding that one
// elementwise op in T does (PyTorch and JAX both compute a bf16 op in float
// and round its result).
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
template <typename T>
__device__ __forceinline__ float rnd(float v) { return round_to(v, T()); }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The prologue of the JAX kernels, one rounding to T after each op:
//   y = ((x - mean) * mul) + bias;  out = max(y, slope * y)
// with mean/mul/bias/slope already rounded to T.  The _rn intrinsics keep
// nvcc from contracting the sub/mul/add into an FMA, which would skip the
// roundings the plain PyTorch version does.
template <typename T>
__device__ __forceinline__ float prologue(float v, float mean, float mul, float bias,
                                          float slope) {
  float y = rnd<T>(__fsub_rn(v, mean));
  y = rnd<T>(__fmul_rn(y, mul));
  y = rnd<T>(__fadd_rn(y, bias));
  return fmaxf(y, rnd<T>(__fmul_rn(y, slope)));
}

// The same prologue on two bf16 values at once, in the card's packed bf16
// arithmetic: bit-equal to prologue<__nv_bfloat16> on each half.  A sum, a
// difference or a product of two bf16 values that is first rounded to f32 and
// then to bf16 equals the one rounded to bf16 directly (the product is exact
// in f32; a sum whose f32 rounding is inexact lies within 2^-17 of its larger
// operand, far from a bf16 tie), and the _rn forms forbid contraction.
__device__ __forceinline__ __nv_bfloat162 prologue2(__nv_bfloat162 v, __nv_bfloat162 mean,
                                                    __nv_bfloat162 mul, __nv_bfloat162 bias,
                                                    __nv_bfloat162 slope) {
  const __nv_bfloat162 y = __hadd2_rn(__hmul2_rn(__hsub2_rn(v, mean), mul), bias);
  return __hmax2(y, __hmul2_rn(y, slope));
}

}  // namespace xv
