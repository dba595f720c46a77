// Per-line fractional shift of packed channels.
//
// Replaces the TPU kernel ops/rowshift.py::_kernel (row_shift_pallas), the
// inner loop of AutoAugment's shears, translations and three-shear rotation:
//   axis 2:  out[b, i, j, c] = x[b, i, j + s, c]   with s = shift[b, i]
//   axis 1:  out[b, i, j, c] = x[b, i + s, j, c]   with s = shift[b, j]
// from the taps lo at k = floor(s) and hi at k + 1, f = s - k:
//   sel[b] != 0 and c < C - 1:  lo * (1 - f) + hi * f
//   else (the last channel is the mask):  f >= 0.5 ? hi : lo   (half-up)
// and zero where the source coordinate pos + s lies outside [0, n - 1].  A tap
// outside the map reads as zero; inside the valid range that only happens to
// hi with f == 0, where it does not change the result.
//
// The TPU kernel rolls a zero-padded (C, Wp) row along the lanes; a thread
// here indexes its two taps directly, so there is no padding, no layout
// change and no bound on the shift, and the vertical passes need no
// transposes.  The lerp is written with _rn intrinsics so that nvcc cannot
// contract it into an FMA: the result equals the plain PyTorch version
// (separate multiplies and an add) bit for bit.
//
// Bound on the H100: bytes, one read and one write of the map.  One thread
// per output pixel, for all C channels: the line's shift, floor, f, the
// source coordinate and the sel branch are computed once per pixel, and the
// grid is two-dimensional (output rows b*H + i on y, columns j on x), so no
// index is divided per element.  Neighbouring threads take neighbouring
// columns of one output row: writes are coalesced, and the reads are the
// shifted line (axis 2) or row i + k(j) at neighbouring columns (axis 1),
// both runs of whole pixels.  At C = 4 (RGB and the mask, the --autoaugment
// path) a pixel is 16 bytes and an integer tap offset keeps that alignment,
// so lo and hi are one 16-byte load each and the output one 16-byte store;
// any other C takes a per-channel loop in the same thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float lerp_rn(float lo, float hi, float f) {
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, f)), __fmul_rn(hi, f));
}

// AXIS 2: a line is output row (b, i), shift[b * h + i]; AXIS 1: a line is
// column j of image b, shift[b * w + j].  VEC4: c == 4 and 16-byte aligned.
template <int AXIS, bool VEC4>
__global__ void __launch_bounds__(MAX_THREADS)
    row_shift_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                     const int* __restrict__ sel, float* __restrict__ out, int rows, int h, int w,
                     int c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= w) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {  // row = b * h + i
    const int b = row / h;
    const int i = row - b * h;
    // the shifted axis: position pos of n, neighbours `stride` elements apart
    const int pos = AXIS == 2 ? j : i;
    const int n = AXIS == 2 ? w : h;
    const int stride = AXIS == 2 ? c : w * c;
    const float* line = x + (AXIS == 2 ? row * w * c : (b * h * w + j) * c);
    float* o = out + (row * w + j) * c;
    const float s = shift[AXIS == 2 ? row : b * w + j];
    const float kf = floorf(s);
    const float f = __fsub_rn(s, kf);
    const float src = __fadd_rn((float)pos, s);
    const bool inside = src >= 0.f && src <= (float)(n - 1);
    // inside the range pos + k is in [0, n - 1] and fits an int
    const int p0 = inside ? pos + (int)kf : 0;
    const bool lo_in = inside && p0 >= 0 && p0 < n;
    const bool hi_in = inside && p0 + 1 >= 0 && p0 + 1 < n;
    const bool soft = sel[b] != 0;
    const bool up = f >= 0.5f;  // the nearest tap, half-up
    if (VEC4) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 lo = lo_in ? *reinterpret_cast<const float4*>(line + p0 * stride) : zero;
      const float4 hi = hi_in ? *reinterpret_cast<const float4*>(line + (p0 + 1) * stride) : zero;
      float4 v = up ? hi : lo;
      if (soft) {
        v.x = lerp_rn(lo.x, hi.x, f);
        v.y = lerp_rn(lo.y, hi.y, f);
        v.z = lerp_rn(lo.z, hi.z, f);
      }
      *reinterpret_cast<float4*>(o) = inside ? v : zero;
    } else {
      const float* lp = line + p0 * stride;
      const float* hp = lp + stride;
      for (int ch = 0; ch < c; ++ch) {
        const float lo = lo_in ? lp[ch] : 0.f;
        const float hi = hi_in ? hp[ch] : 0.f;
        float v = 0.f;
        if (inside) v = soft && ch != c - 1 ? lerp_rn(lo, hi, f) : (up ? hi : lo);
        o[ch] = v;
      }
    }
  }
}

template <int AXIS, bool VEC4>
cudaError_t launch(const float* x, const float* shift, const int* sel, float* out, int b, int h,
                   int w, int c, cudaStream_t stream) {
  // columns over the fewest blocks of at most MAX_THREADS, the threads
  // spread evenly (654 columns: 3 x 224)
  const int bx = (w + MAX_THREADS - 1) / MAX_THREADS;
  const int threads = ((w + bx - 1) / bx + 31) / 32 * 32;
  const int rows = b * h;
  const dim3 grid((unsigned)bx, (unsigned)(rows < 65535 ? rows : 65535));
  row_shift_kernel<AXIS, VEC4><<<grid, threads, 0, stream>>>(x, shift, sel, out, rows, h, w, c);
  return cudaGetLastError();
}

}  // namespace

// x, out: (b, h, w, c) float32 contiguous, fewer than 2^31 elements; shift:
// (b, h) for axis 2 or (b, w) for axis 1, float32 contiguous; sel: (b,)
// int32.  Returns the cudaError_t of the launch (0 on success); an empty map
// launches nothing.
extern "C" int row_shift(const void* x, const void* shift, const void* sel, void* out, int b,
                         int h, int w, int c, int axis, void* stream) {
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * h * w * c;
  if (total <= 0) return (int)cudaSuccess;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const float* xs = (const float*)x;
  const float* sh = (const float*)shift;
  const int* se = (const int*)sel;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = c == 4 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)out % 16) == 0;
  if (axis == 2)
    return (int)(vec4 ? launch<2, true>(xs, sh, se, o, b, h, w, c, s)
                      : launch<2, false>(xs, sh, se, o, b, h, w, c, s));
  return (int)(vec4 ? launch<1, true>(xs, sh, se, o, b, h, w, c, s)
                    : launch<1, false>(xs, sh, se, o, b, h, w, c, s));
}
