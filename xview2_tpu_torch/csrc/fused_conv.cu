// Fused conv+BN forward: fold + LeakyReLU prologue, 3x3 SAME conv, BN sums.
//
// Replaces the TPU kernel ops/packed_fused_conv.py::_kernel (_fwd_impl,
// reached through conv_bn_fused).  For x (B, H, W, C) NHWC and the kernel as
// a (9C, Co) matrix with rows (dy, dx, c):
//   a   = prologue(x) inside the image, 0 in the SAME halo (common.cuh);
//         without a fold, a = x
//   out = T(sum_{dy,dx,c} a[b, y+dy-1, x+dx-1, c] * k[dy, dx, c, o])  (f32 acc)
//   s1[o] = sum over (b, y, x) of float(out);  s2[o] = sum of float(out)^2
// The sums are taken over the CAST output, as _PackedBN does.
//
// Bound on the H100: operations.  The main-path layers do 9*C*2 FLOP per
// output element against 2*(C + Co) bytes of activations per pixel, i.e.
// hundreds of FLOP per byte (dec_l5 at C = Co = 128: 1152 FLOP per output
// element), above the card's ~295 FLOP/byte bf16 ridge.
//
// Design (a simple implicit GEMM; wgmma/TMA pipelines are later work; the
// tile code is conv_tile.cuh, shared with the backward kernels):
//  * one block of 256 threads per (batch, group of ROWS output rows,
//    TM = 128 output columns, TN = 64 output channels);
//  * the K loop walks C in chunks of KC channels; per chunk the block stages
//    the 3 input rows (plus the 1-pixel halo) into shared memory with the
//    prologue applied while staging, and the 9 taps' (KC x TN) weight slabs;
//  * bf16: each warp owns 16 output pixels x 64 channels as four 16x16
//    nvcuda::wmma f32 accumulators; the 3 dx taps of one staged row are the
//    same shared-memory tile read at a one-row offset (the row stride of 96
//    bytes keeps every fragment pointer 32-byte aligned, at the price of
//    2-way bank conflicts on the A fragments);
//  * f32: a plain FMA loop, 8 pixels x 4 channels per thread, no TF32, so
//    --precision 32 keeps its meaning;
//  * epilogue: cast, store, and per-thread partial sums of s1/s2 kept in
//    registers across the block's rows; one shared-memory reduction and one
//    atomicAdd per channel per block into the zeroed f32 outputs.

#include "conv_tile.cuh"

namespace {

using namespace xv;

template <bool FOLD>
__global__ void __launch_bounds__(THREADS) conv_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ kmat,
    const float* __restrict__ fold, __nv_bfloat16* __restrict__ out, float* __restrict__ s1,
    float* __restrict__ s2, int h, int w, int c, int co, int row_groups, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);      // the row's result tile
  float* fs = reinterpret_cast<float*>(smem + STAGE_BYTES_H);  // (3, c) fold, rounded
  float* red = fs + 3 * c;                                     // (2, 4, TN) partial sums

  const int tid = threadIdx.x;
  const int b = blockIdx.x / row_groups;
  const int y0 = (blockIdx.x - b * row_groups) * ROWS;
  const int x0 = (blockIdx.y % col_tiles) * TM;
  const int co0 = (blockIdx.y / col_tiles) * TN;
  const float slope = rnd<__nv_bfloat16>(kLeakySlope);
  if (FOLD) {
    for (int i = tid; i < 3 * c; i += THREADS) fs[i] = rnd<__nv_bfloat16>(fold[i]);
  }
  // epilogue ownership: channel en, pixels r = tid/TN + 4*i
  const int en = tid % TN;
  float p1 = 0.f, p2 = 0.f;

  for (int y = y0; y < min(y0 + ROWS, h); ++y) {
    conv_row_bf16<FOLD>(smem, x, kmat, fs, b, y, x0, co0, h, w, c, co, slope);
    for (int r = tid / TN; r < TM; r += THREADS / TN) {
      if (x0 + r < w) {
        const __nv_bfloat16 o = __float2bfloat16(Cs[r * LDC_H + en]);
        out[(((size_t)b * h + y) * w + x0 + r) * co + co0 + en] = o;
        const float f = __bfloat162float(o);
        p1 += f;
        p2 = fmaf(f, f, p2);
      }
    }
  }
  reduce_sums_bf16(red, p1, p2, s1 + co0, s2 + co0);
}

template <bool FOLD>
__global__ void __launch_bounds__(THREADS) conv_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ kmat, const float* __restrict__ fold,
    float* __restrict__ out, float* __restrict__ s1, float* __restrict__ s2, int h, int w, int c,
    int co, int row_groups, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* fs = reinterpret_cast<float*>(smem + STAGE_BYTES_F);  // (3, c)
  float* red = fs + 3 * c;                                     // (2, 16, TN)

  const int tid = threadIdx.x;
  const int tn = tid % 16;  // channels tn*4 .. tn*4+3
  const int tm = tid / 16;  // pixels tm*8 .. tm*8+7
  const int b = blockIdx.x / row_groups;
  const int y0 = (blockIdx.x - b * row_groups) * ROWS;
  const int x0 = (blockIdx.y % col_tiles) * TM;
  const int co0 = (blockIdx.y / col_tiles) * TN;
  if (FOLD) {
    for (int i = tid; i < 3 * c; i += THREADS) fs[i] = fold[i];
  }
  float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};

  for (int y = y0; y < min(y0 + ROWS, h); ++y) {
    float acc[8][4];
    conv_row_f32<FOLD>(smem, acc, x, kmat, fs, b, y, x0, co0, h, w, c, co);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int xm = x0 + tm * 8 + i;
      if (xm < w) {
        *reinterpret_cast<float4*>(out + (((size_t)b * h + y) * w + xm) * co + co0 + tn * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p1[j] += acc[i][j];
          p2[j] = fmaf(acc[i][j], acc[i][j], p2[j]);
        }
      }
    }
  }
  reduce_sums_f32(red, p1, p2, s1 + co0, s2 + co0);
}

template <typename T, typename K>
cudaError_t launch(K kern, size_t smem, const void* x, const void* kmat, const float* fold,
                   void* out, float* s1, float* s2, int b, int h, int w, int c, int co,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int row_groups = (h + ROWS - 1) / ROWS;
  const int col_tiles = (w + TM - 1) / TM;
  const dim3 grid((unsigned)(b * row_groups), (unsigned)(col_tiles * (co / TN)));
  if (grid.x > 0 && grid.y > 0)
    kern<<<grid, THREADS, smem, stream>>>((const T*)x, (const T*)kmat, fold, (T*)out, s1, s2, h,
                                          w, c, co, row_groups, col_tiles);
  return cudaGetLastError();
}

}  // namespace

// x: (b, h, w, c) contiguous; kmat: (9c, co) contiguous, same dtype as x;
// fold: (3, c) f32 = mean, mul, bias, or NULL for no prologue; out: (b, h, w,
// co); s1, s2: (co,) f32, zeroed by the caller.  dtype 0 = float32 (c % 16 ==
// 0), 1 = bfloat16 (c % 32 == 0); co % 64 == 0 for both.  Returns the
// cudaError_t of the launch.
extern "C" int conv_bn_fused(const void* x, const void* kmat, const void* fold, void* out,
                             void* s1, void* s2, int b, int h, int w, int c, int co, int dtype,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)fold;
  float* a = (float*)s1;
  float* q = (float*)s2;
  if (co % TN) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (c % KC_H) return (int)cudaErrorInvalidValue;
    const size_t smem = STAGE_BYTES_H + 3ull * c * 4 + RED_BYTES_H;
    if (f)
      return (int)launch<__nv_bfloat16>(conv_bf16_kernel<true>, smem, x, kmat, f, out, a, q, b,
                                        h, w, c, co, s);
    return (int)launch<__nv_bfloat16>(conv_bf16_kernel<false>, smem, x, kmat, f, out, a, q, b, h,
                                      w, c, co, s);
  }
  if (dtype == 0) {
    if (c % KC_F) return (int)cudaErrorInvalidValue;
    const size_t smem = STAGE_BYTES_F + 3ull * c * 4 + RED_BYTES_F;
    if (f)
      return (int)launch<float>(conv_f32_kernel<true>, smem, x, kmat, f, out, a, q, b, h, w, c,
                                co, s);
    return (int)launch<float>(conv_f32_kernel<false>, smem, x, kmat, f, out, a, q, b, h, w, c, co,
                              s);
  }
  return (int)cudaErrorInvalidValue;
}
