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
// element), above the card's ~295 FLOP/byte bf16 ridge.  The least time for
// the six layers of an eval step (4.9 TFLOP) is 5.0 ms, of a train step 1.25.
//
// Design.  Three kernels, chosen in the C entry point by the static shape and
// dtype only (conv_bn_fused_variant reports the choice):
//  * bf16 with Co % 128 == 0 (every layer of the decoder tail): the
//    pipelined wgmma tile of conv_mma.cuh.  A block of 256 threads owns 256
//    output pixels shaped R x TW (2 x 128, 4 x 64, 8 x 32 or 16 x 16,
//    whichever wastes least of this H x W) and 128 output channels, so the
//    input is read Co/128 times.  Per chunk of 16 input channels one halo
//    patch and the nine weight slabs are staged ONCE by cp.async into a
//    three-stage ring, two chunks ahead of the MMAs; the prologue runs in
//    place on the landed patch, once per element, behind queued MMAs;
//    wgmma.m64n128k16 with the activations from registers (ldmatrix, a tap is
//    a pointer offset) and the weights from swizzled shared memory, 128 f32
//    accumulators a thread.  The epilogue goes from the accumulator
//    fragments: bf16 pairs, transposed over the four lanes of a quad into
//    16-byte stores, straight to device memory; s1/s2 from the same rounded
//    values by warp shuffles, one shared-memory reduction over the eight
//    warps and one atomicAdd per channel per tile.  out has no
//    atomics: it is bit-equal from run to run.  Blocks are persistent, one
//    per SM, and the ring runs on from one tile into the next, so a tile's
//    epilogue overlaps the next tile's copies.  Not done yet: TMA (multicast
//    in a cluster) for the weights, a producer warp.
//  * bf16 with another Co (64, 192): the wmma row tile of conv_tile.cuh, one
//    block per (8 rows, 128 columns, 64 channels), no copy/compute overlap.
//  * f32: a plain FMA loop, 8 pixels x 4 channels per thread, no TF32, so
//    --precision 32 keeps its meaning.
//    Both keep per-thread partial sums of s1/s2 across a block's rows, then
//    one shared-memory reduction and one atomicAdd per channel per block.

#include "conv_mma.cuh"
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

// The pipelined bf16 kernel: persistent blocks over the tiles (R rows x TW
// columns x 128 output channels) of conv_mma.cuh's main loop; this is its
// epilogue.
template <int TW, bool FOLD>
__global__ void __launch_bounds__(mm::THREADS, 1) conv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ kmat,
    const float* __restrict__ fold, __nv_bfloat16* __restrict__ out, float* __restrict__ s1,
    float* __restrict__ s2, const mm::ConvGeom gm) {
  using T = mm::Tile<TW>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + T::SMEM);                       // (2, 8, 128) sums
  __nv_bfloat16* fs = reinterpret_cast<__nv_bfloat16*>(red + 2 * 8 * mm::TNB);  // (3, c) fold

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (FOLD) {
    for (int i = tid; i < 3 * gm.cin; i += mm::THREADS) fs[i] = __float2bfloat16(fold[i]);
    __syncthreads();
  }

  // epilogue from the fragments, four n8 tiles at a time: this lane holds rows
  // g and g + 8 of its warp's 16 in both m64 blocks, channels j*8 + q*2, +1 of
  // tile j.  A 4 x 4 transpose over the four lanes of a quad (two shuffle
  // rounds) gives lane q all eight channels of tile 4*jj + q: one 16-byte
  // store a row instead of four 4-byte ones, whole 32-byte sectors.
  auto epilogue = [&](const float (&acc)[2][64], int b, int y0, int x0, int co0) {
    const int g = lane >> 2, q = lane & 3;
    __nv_bfloat16* dst[2][2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (warp >> 2) * 128 + mb * 64 + (warp & 3) * 16 + g + hh * 8;
        const int y = y0 + p / TW, xx = x0 + p % TW;
        dst[mb][hh] = (y < gm.h && xx < gm.w)
                          ? out + (((size_t)b * gm.h + y) * gm.w + xx) * gm.cout + co0 + q * 8
                          : nullptr;
      }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float p1[4][2], p2[4][2];
#pragma unroll
      for (int k = 0; k < 4; ++k) p1[k][0] = p1[k][1] = p2[k][0] = p2[k][1] = 0.f;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t v[4];  // this row's channel pair of tiles 4*jj .. 4*jj + 3
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * jj + k;
            const __nv_bfloat162 o =
                __floats2bfloat162_rn(acc[mb][4 * j + hh * 2], acc[mb][4 * j + hh * 2 + 1]);
            v[k] = *reinterpret_cast<const uint32_t*>(&o);
            if (dst[mb][hh]) {
              const float f0 = __low2float(o), f1 = __high2float(o);
              p1[k][0] += f0;
              p1[k][1] += f1;
              p2[k][0] = fmaf(f0, f0, p2[k][0]);
              p2[k][1] = fmaf(f1, f1, p2[k][1]);
            }
          }
          mm::quad_transpose(v, q);
          if (dst[mb][hh])
            *reinterpret_cast<uint4*>(dst[mb][hh] + jj * 32) = make_uint4(v[0], v[1], v[2], v[3]);
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            p1[k][e] += __shfl_xor_sync(0xffffffffu, p1[k][e], m);
            p2[k][e] += __shfl_xor_sync(0xffffffffu, p2[k][e], m);
          }
          if (g == 0) {
            red[warp * mm::TNB + (4 * jj + k) * 8 + q * 2 + e] = p1[k][e];
            red[(8 + warp) * mm::TNB + (4 * jj + k) * 8 + q * 2 + e] = p2[k][e];
          }
        }
    }
    __syncthreads();
    const int n = tid & (mm::TNB - 1), which = tid / mm::TNB;  // 0: s1, 1: s2
    const float* r = red + which * 8 * mm::TNB + n;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) v += r[k * mm::TNB];
    atomicAdd((which ? s2 : s1) + co0 + n, v);
  };
  mm::conv_tiles_wgmma<TW, FOLD>(smem, x, kmat, fs, gm, epilogue);
}

template <int TW>
cudaError_t launch_wgmma(const void* x, const void* kmat, const float* fold, void* out, float* s1,
                         float* s2, int b, int h, int w, int c, int co, cudaStream_t stream) {
  using T = mm::Tile<TW>;
  const size_t smem = (size_t)T::SMEM + 2ull * 8 * mm::TNB * 4 + 3ull * c * 2;
  auto kern = fold ? conv_wgmma_kernel<TW, true> : conv_wgmma_kernel<TW, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mm::ConvGeom gm;
  unsigned blocks = 0;
  if ((err = mm::conv_launch_shape<TW>(b, h, w, c, co, gm, blocks)) != cudaSuccess) return err;
  if (blocks > 0)
    kern<<<blocks, mm::THREADS, smem, stream>>>((const __nv_bfloat16*)x,
                                                (const __nv_bfloat16*)kmat, fold,
                                                (__nv_bfloat16*)out, s1, s2, gm);
  return cudaGetLastError();
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
    if (co % mm::TNB == 0) {
      switch (mm::pick_tile_width(h, w)) {
        case 128: return (int)launch_wgmma<128>(x, kmat, f, out, a, q, b, h, w, c, co, s);
        case 64: return (int)launch_wgmma<64>(x, kmat, f, out, a, q, b, h, w, c, co, s);
        case 32: return (int)launch_wgmma<32>(x, kmat, f, out, a, q, b, h, w, c, co, s);
        default: return (int)launch_wgmma<16>(x, kmat, f, out, a, q, b, h, w, c, co, s);
      }
    }
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

// Which kernel conv_bn_fused launches for this static shape and dtype: 0 = the
// f32 FMA kernel, 1 = the bf16 wmma row tile (8 rows x 128 columns x 64
// channels), else the tile width TW of the pipelined wgmma kernel (its block
// tile is 256 / TW rows x TW columns x 128 channels); -1 = not taken.
extern "C" int conv_bn_fused_variant(int h, int w, int c, int co, int dtype) {
  if (co % TN) return -1;
  if (dtype == 0) return c % KC_F ? -1 : 0;
  if (dtype != 1 || c % KC_H) return -1;
  return co % mm::TNB == 0 ? mm::pick_tile_width(h, w) : 1;
}
