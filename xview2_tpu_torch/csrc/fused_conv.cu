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
// Design (a simple implicit GEMM; wgmma/TMA pipelines are later work):
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

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace xv;
using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int TM = 128;   // output pixels (along W) per block
constexpr int TN = 64;    // output channels per block
constexpr int ROWS = 8;   // output rows per block
constexpr int AW = TM + 2;  // staged input columns (with halo)

// ---------------------------------------------------------------- bf16 (wmma)
constexpr int KC_H = 32;            // channels per K chunk
constexpr int LDA_H = KC_H + 16;    // 48 halves = 96 bytes per staged pixel
constexpr int LDB_H = TN + 8;       // 72 halves = 144 bytes: conflict-free, and 16 rows = 2304 bytes keep fragments aligned
constexpr int LDC_H = TN + 4;       // f32 epilogue tile stride
constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }
constexpr size_t A_BYTES_H = align128(3ull * AW * LDA_H * 2);
constexpr size_t B_BYTES_H = 9ull * KC_H * LDB_H * 2;
constexpr size_t STAGE_BYTES_H = A_BYTES_H + B_BYTES_H;
static_assert((size_t)TM * LDC_H * 4 <= STAGE_BYTES_H, "epilogue tile must fit the staging area");

template <bool FOLD>
__global__ void __launch_bounds__(THREADS) conv_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ kmat,
    const float* __restrict__ fold, __nv_bfloat16* __restrict__ out, float* __restrict__ s1,
    float* __restrict__ s2, int h, int w, int c, int co, int row_groups, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES_H);
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue, aliases the staging area
  float* fs = reinterpret_cast<float*>(smem + STAGE_BYTES_H);  // (3, c) fold, rounded
  float* red = fs + 3 * c;                                     // (2, 4, TN) partial sums

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int b = blockIdx.x / row_groups;
  const int y0 = (blockIdx.x - b * row_groups) * ROWS;
  const int x0 = (blockIdx.y % col_tiles) * TM;
  const int co0 = (blockIdx.y / col_tiles) * TN;
  const float slope = rnd<__nv_bfloat16>(kLeakySlope);
  if (FOLD) {
    for (int i = tid; i < 3 * c; i += THREADS) fs[i] = rnd<__nv_bfloat16>(fold[i]);
  }
  // epilogue ownership: channel n, pixels r = tid/TN + 4*i
  const int en = tid % TN;
  float p1 = 0.f, p2 = 0.f;

  for (int y = y0; y < min(y0 + ROWS, h); ++y) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

    for (int c0 = 0; c0 < c; c0 += KC_H) {
      __syncthreads();  // previous chunk's (or row's epilogue) reads are done
      // stage A: rows y-1..y+1, columns x0-1..x0+TM, KC_H channels, 8 per vector
      for (int v = tid; v < 3 * AW * (KC_H / 8); v += THREADS) {
        const int kv = v % (KC_H / 8);
        const int j = (v / (KC_H / 8)) % AW;
        const int dy = v / (KC_H / 8) / AW;
        const int yy = y + dy - 1, xx = x0 + j - 1;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
          val = *reinterpret_cast<const uint4*>(x + (((size_t)b * h + yy) * w + xx) * c + c0 + kv * 8);
          if (FOLD) {
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int ch = c0 + kv * 8 + k;
              e[k] = __float2bfloat16(prologue<__nv_bfloat16>(
                  __bfloat162float(e[k]), fs[ch], fs[c + ch], fs[2 * c + ch], slope));
            }
          }
        }
        *reinterpret_cast<uint4*>(As + (dy * AW + j) * LDA_H + kv * 8) = val;
      }
      // stage B: 9 taps x KC_H rows x TN columns
      for (int v = tid; v < 9 * KC_H * (TN / 8); v += THREADS) {
        const int nv = v % (TN / 8);
        const int k = (v / (TN / 8)) % KC_H;
        const int t = v / (TN / 8) / KC_H;
        *reinterpret_cast<uint4*>(Bs + (t * KC_H + k) * LDB_H + nv * 8) =
            *reinterpret_cast<const uint4*>(kmat + ((size_t)t * c + c0 + k) * co + co0 + nv * 8);
      }
      __syncthreads();

#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int t = dy * 3 + dx;
#pragma unroll
          for (int ks = 0; ks < KC_H / 16; ++ks) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::load_matrix_sync(af, As + (dy * AW + warp * 16 + dx) * LDA_H + ks * 16, LDA_H);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
              wmma::load_matrix_sync(bf, Bs + (t * KC_H + ks * 16) * LDB_H + j * 16, LDB_H);
              wmma::mma_sync(acc[j], af, bf, acc[j]);
            }
          }
        }
      }
    }

    __syncthreads();  // all warps are done reading As/Bs before Cs overwrites them
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (warp * 16) * LDC_H + j * 16, acc[j], LDC_H, wmma::mem_row_major);
    __syncthreads();
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

  __syncthreads();
  red[(tid / TN) * TN + en] = p1;
  red[4 * TN + (tid / TN) * TN + en] = p2;
  __syncthreads();
  if (tid < TN) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int g = 0; g < THREADS / TN; ++g) {
      a += red[g * TN + tid];
      q += red[4 * TN + g * TN + tid];
    }
    atomicAdd(s1 + co0 + tid, a);
    atomicAdd(s2 + co0 + tid, q);
  }
}

// ---------------------------------------------------------------- f32 (FMA)
constexpr int KC_F = 16;
constexpr int LDA_F = KC_F + 1;  // odd stride: the two pixel groups of a warp hit different banks
constexpr size_t A_BYTES_F = align128(3ull * AW * LDA_F * 4);
constexpr size_t B_BYTES_F = 9ull * KC_F * TN * 4;

template <bool FOLD>
__global__ void __launch_bounds__(THREADS) conv_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ kmat, const float* __restrict__ fold,
    float* __restrict__ out, float* __restrict__ s1, float* __restrict__ s2, int h, int w, int c,
    int co, int row_groups, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + A_BYTES_F);
  float* fs = reinterpret_cast<float*>(smem + A_BYTES_F + B_BYTES_F);  // (3, c)
  float* red = fs + 3 * c;                                             // (2, 16, TN)

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
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < c; c0 += KC_F) {
      __syncthreads();
      for (int v = tid; v < 3 * AW * (KC_F / 4); v += THREADS) {
        const int kv = v % (KC_F / 4);
        const int j = (v / (KC_F / 4)) % AW;
        const int dy = v / (KC_F / 4) / AW;
        const int yy = y + dy - 1, xx = x0 + j - 1;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
          val = *reinterpret_cast<const float4*>(x + (((size_t)b * h + yy) * w + xx) * c + c0 + kv * 4);
          if (FOLD) {
            float* e = reinterpret_cast<float*>(&val);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int ch = c0 + kv * 4 + k;
              e[k] = prologue<float>(e[k], fs[ch], fs[c + ch], fs[2 * c + ch], kLeakySlope);
            }
          }
        }
        float* dst = As + (dy * AW + j) * LDA_F + kv * 4;
        dst[0] = val.x;
        dst[1] = val.y;
        dst[2] = val.z;
        dst[3] = val.w;
      }
      for (int v = tid; v < 9 * KC_F * (TN / 4); v += THREADS) {
        const int nv = v % (TN / 4);
        const int k = (v / (TN / 4)) % KC_F;
        const int t = v / (TN / 4) / KC_F;
        *reinterpret_cast<float4*>(Bs + (t * KC_F + k) * TN + nv * 4) =
            *reinterpret_cast<const float4*>(kmat + ((size_t)t * c + c0 + k) * co + co0 + nv * 4);
      }
      __syncthreads();

      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int t = dy * 3 + dx;
#pragma unroll 4
          for (int k = 0; k < KC_F; ++k) {
            const float4 bv = *reinterpret_cast<const float4*>(Bs + (t * KC_F + k) * TN + tn * 4);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float a = As[(dy * AW + tm * 8 + i + dx) * LDA_F + k];
              acc[i][0] = fmaf(a, bv.x, acc[i][0]);
              acc[i][1] = fmaf(a, bv.y, acc[i][1]);
              acc[i][2] = fmaf(a, bv.z, acc[i][2]);
              acc[i][3] = fmaf(a, bv.w, acc[i][3]);
            }
          }
        }
      }
    }

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

  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[tm * TN + tn * 4 + j] = p1[j];
    red[16 * TN + tm * TN + tn * 4 + j] = p2[j];
  }
  __syncthreads();
  if (tid < TN) {
    float a = 0.f, q = 0.f;
    for (int g = 0; g < 16; ++g) {
      a += red[g * TN + tid];
      q += red[16 * TN + g * TN + tid];
    }
    atomicAdd(s1 + co0 + tid, a);
    atomicAdd(s2 + co0 + tid, q);
  }
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
    const size_t smem = STAGE_BYTES_H + 3ull * c * 4 + 2ull * 4 * TN * 4;
    if (f)
      return (int)launch<__nv_bfloat16>(conv_bf16_kernel<true>, smem, x, kmat, f, out, a, q, b,
                                        h, w, c, co, s);
    return (int)launch<__nv_bfloat16>(conv_bf16_kernel<false>, smem, x, kmat, f, out, a, q, b, h,
                                      w, c, co, s);
  }
  if (dtype == 0) {
    if (c % KC_F) return (int)cudaErrorInvalidValue;
    const size_t smem = A_BYTES_F + B_BYTES_F + 3ull * c * 4 + 2ull * 16 * TN * 4;
    if (f)
      return (int)launch<float>(conv_f32_kernel<true>, smem, x, kmat, f, out, a, q, b, h, w, c,
                                co, s);
    return (int)launch<float>(conv_f32_kernel<false>, smem, x, kmat, f, out, a, q, b, h, w, c, co,
                              s);
  }
  return (int)cudaErrorInvalidValue;
}
