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
// per output element, in output order: writes are coalesced, and the reads of
// neighbouring threads are neighbouring addresses of the shifted line (axis 2)
// or C-element runs of neighbouring columns (axis 1).

#include <cuda_runtime.h>

namespace {

__global__ void row_shift_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                                 const int* __restrict__ sel, float* __restrict__ out,
                                 unsigned total, int h, int w, int c, int axis) {
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += step) {
    unsigned r = idx;
    const int ch = (int)(r % (unsigned)c);
    r /= (unsigned)c;
    const int j = (int)(r % (unsigned)w);
    r /= (unsigned)w;
    const int i = (int)(r % (unsigned)h);
    const int b = (int)(r / (unsigned)h);

    // the shifted axis: position pos of n, one shift per line of the other axis
    const int pos = axis == 2 ? j : i;
    const int n = axis == 2 ? w : h;
    const int stride = axis == 2 ? c : w * c;
    const float s = axis == 2 ? shift[b * h + i] : shift[b * w + j];
    const float kf = floorf(s);
    const float f = __fsub_rn(s, kf);
    const float src = __fadd_rn((float)pos, s);
    float v = 0.f;
    if (src >= 0.f && src <= (float)(n - 1)) {
      // inside the range pos + k is in [0, n - 1] and fits an int
      const int p0 = pos + (int)kf;
      const float* line = x + ((long long)idx - (long long)pos * stride);
      const float lo = (p0 >= 0 && p0 < n) ? line[(long long)p0 * stride] : 0.f;
      const float hi = (p0 + 1 >= 0 && p0 + 1 < n) ? line[(long long)(p0 + 1) * stride] : 0.f;
      if (sel[b] != 0 && ch != c - 1) {
        v = __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, f)), __fmul_rn(hi, f));
      } else {
        v = f >= 0.5f ? hi : lo;
      }
    }
    out[idx] = v;
  }
}

}  // namespace

// x, out: (b, h, w, c) float32 contiguous, fewer than 2^31 elements; shift:
// (b, h) for axis 2 or (b, w) for axis 1, float32; sel: (b,) int32.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int row_shift(const void* x, const void* shift, const void* sel, void* out, int b,
                         int h, int w, int c, int axis, void* stream) {
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * h * w * c;
  if (total <= 0) return (int)cudaSuccess;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond ~64 blocks per SM
  row_shift_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)shift, (const int*)sel, (float*)out, (unsigned)total, h, w,
      c, axis);
  return (int)cudaGetLastError();
}
