// Tile code shared by the implicit-GEMM 3x3 SAME convolutions: the fused
// conv+BN forward (fused_conv.cu) and its two backward kernels
// (fused_conv_bwd.cu).
//
//  * stage_rows: three input rows (with the 1-pixel halo) of one channel
//    chunk into shared memory, the fold + LeakyReLU prologue applied while
//    staging and the SAME halo left at zero AFTER it;
//  * stage_weights: the nine taps' (KC x TN) slabs of a (9*Cin, Cout) matrix;
//  * conv_row_bf16 / conv_row_f32: the K loop of one output row of one block
//    tile (TM pixels x TN output channels), wmma with f32 accumulators for
//    bf16, a plain FMA loop (no TF32) for f32;
//  * reduce_sums_*: a block's per-thread partial channel sums into one
//    atomicAdd per channel.
#pragma once

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace xv {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int TM = 128;     // output pixels (along W) per block
constexpr int TN = 64;      // output channels per block
constexpr int ROWS = 8;     // output rows per block
constexpr int AW = TM + 2;  // staged input columns (with halo)

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// ---------------------------------------------------------------- bf16 (wmma)
constexpr int KC_H = 32;          // channels per K chunk
constexpr int LDA_H = KC_H + 16;  // 48 halves = 96 bytes per staged pixel: every fragment pointer stays 32-byte aligned
constexpr int LDB_H = TN + 8;     // 72 halves = 144 bytes: conflict-free, and 16 rows = 2304 bytes keep fragments aligned
constexpr int LDC_H = TN + 4;     // f32 result tile stride
constexpr size_t A_BYTES_H = align128(3ull * AW * LDA_H * 2);
constexpr size_t B_BYTES_H = 9ull * KC_H * LDB_H * 2;
constexpr size_t STAGE_BYTES_H = A_BYTES_H + B_BYTES_H;
static_assert((size_t)TM * LDC_H * 4 <= STAGE_BYTES_H, "result tile must fit the staging area");

// ---------------------------------------------------------------- f32 (FMA)
constexpr int KC_F = 16;
constexpr int LDA_F = KC_F + 1;  // odd stride: the two pixel groups of a warp hit different banks
constexpr size_t A_BYTES_F = align128(3ull * AW * LDA_F * 4);
constexpr size_t B_BYTES_F = 9ull * KC_F * TN * 4;
constexpr size_t STAGE_BYTES_F = A_BYTES_F + B_BYTES_F;

// Stage rows y-1..y+1, columns x0-1 .. x0+aw-2, channels c0 .. c0+KC-1 of the
// NHWC map x (b, h, w, c) as As[(dy*aw + j)*LD + k].  With FOLD the prologue
// is applied to pixels inside the image (fs = (3, c) mean, mul, bias already
// rounded to T); pixels of the SAME halo stay 0 whatever the fold.
template <typename T, bool FOLD, int KC, int LD>
__device__ __forceinline__ void stage_rows(T* __restrict__ As, const T* __restrict__ x,
                                           const float* __restrict__ fs, int b, int y, int x0,
                                           int c0, int h, int w, int c, int aw, float slope) {
  constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte vector
  constexpr int KV = KC / V;
  for (int v = threadIdx.x; v < 3 * aw * KV; v += THREADS) {
    const int kv = v % KV;
    const int j = (v / KV) % aw;
    const int dy = v / KV / aw;
    const int yy = y + dy - 1, xx = x0 + j - 1;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      val = *reinterpret_cast<const uint4*>(x + (((size_t)b * h + yy) * w + xx) * c + c0 + kv * V);
      if (FOLD) {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int ch = c0 + kv * V + k;
          e[k] = from_float<T>(
              prologue<T>(to_float(e[k]), fs[ch], fs[c + ch], fs[2 * c + ch], slope));
        }
      }
    }
    T* dst = As + (dy * aw + j) * LD + kv * V;
    if constexpr (LD % V == 0) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int k = 0; k < V; ++k) dst[k] = e[k];
    }
  }
}

// Stage the nine taps' (KC x TN) slabs of kmat (9*cin, cout), rows (tap, c),
// as Bs[(t*KC + k)*LD + n] for input channels c0.. and output channels n0..
template <typename T, int KC, int LD>
__device__ __forceinline__ void stage_weights(T* __restrict__ Bs, const T* __restrict__ kmat,
                                              int c0, int n0, int cin, int cout) {
  constexpr int V = 16 / (int)sizeof(T);
  for (int v = threadIdx.x; v < 9 * KC * (TN / V); v += THREADS) {
    const int nv = v % (TN / V);
    const int k = (v / (TN / V)) % KC;
    const int t = v / (TN / V) / KC;
    *reinterpret_cast<uint4*>(Bs + (t * KC + k) * LD + nv * V) =
        *reinterpret_cast<const uint4*>(kmat + ((size_t)t * cin + c0 + k) * cout + n0 + nv * V);
  }
}

// One output row of one block tile in bf16: out[r][n] = sum_{dy,dx,k}
// a[y+dy-1][x0+r+dx-1][k] * kmat[(dy,dx,k)][n0+n], f32 accumulation.  Each
// warp owns 16 pixels x 64 channels as four 16x16 wmma accumulators; the 3 dx
// taps of one staged row are the same shared-memory tile read at a one-pixel
// offset.  On return the (TM x TN) f32 result lies in smem (stride LDC_H,
// aliasing the staging area) and the block is synchronised; the caller's next
// call starts with a barrier before it stages again.
template <bool FOLD>
__device__ __forceinline__ void conv_row_bf16(unsigned char* smem,
                                              const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ kmat,
                                              const float* __restrict__ fs, int b, int y, int x0,
                                              int n0, int h, int w, int cin, int cout,
                                              float slope) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES_H);
  float* Cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < cin; c0 += KC_H) {
    __syncthreads();  // the previous chunk's (or row's epilogue) reads are done
    stage_rows<__nv_bfloat16, FOLD, KC_H, LDA_H>(As, x, fs, b, y, x0, c0, h, w, cin, AW, slope);
    stage_weights<__nv_bfloat16, KC_H, LDB_H>(Bs, kmat, c0, n0, cin, cout);
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
    wmma::store_matrix_sync(Cs + (warp * 16) * LDC_H + j * 16, acc[j], LDC_H,
                            wmma::mem_row_major);
  __syncthreads();
}

// The same row in f32: thread (tm, tn) = (tid / 16, tid % 16) owns pixels
// tm*8 .. tm*8+7 and channels tn*4 .. tn*4+3 in registers.
template <bool FOLD>
__device__ __forceinline__ void conv_row_f32(unsigned char* smem, float (&acc)[8][4],
                                             const float* __restrict__ x,
                                             const float* __restrict__ kmat,
                                             const float* __restrict__ fs, int b, int y, int x0,
                                             int n0, int h, int w, int cin, int cout) {
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + A_BYTES_F);
  const int tn = threadIdx.x % 16;
  const int tm = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += KC_F) {
    __syncthreads();
    stage_rows<float, FOLD, KC_F, LDA_F>(As, x, fs, b, y, x0, c0, h, w, cin, AW, kLeakySlope);
    stage_weights<float, KC_F, TN>(Bs, kmat, c0, n0, cin, cout);
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
}

// Block reduction of per-thread partial channel sums, bf16 thread layout
// (channel tid % TN, pixel group tid / TN): red is (2, 4, TN) floats; one
// atomicAdd per channel into the zeroed outputs o1/o2 (already offset to the
// block's first channel).
__device__ __forceinline__ void reduce_sums_bf16(float* red, float p1, float p2,
                                                 float* __restrict__ o1,
                                                 float* __restrict__ o2) {
  const int tid = threadIdx.x;
  __syncthreads();
  red[(tid / TN) * TN + tid % TN] = p1;
  red[4 * TN + (tid / TN) * TN + tid % TN] = p2;
  __syncthreads();
  if (tid < TN) {
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int g = 0; g < THREADS / TN; ++g) {
      a += red[g * TN + tid];
      q += red[4 * TN + g * TN + tid];
    }
    atomicAdd(o1 + tid, a);
    atomicAdd(o2 + tid, q);
  }
}

// The same for the f32 thread layout (channels tn*4.., pixel group tm): red
// is (2, 16, TN) floats.
__device__ __forceinline__ void reduce_sums_f32(float* red, const float (&p1)[4],
                                                const float (&p2)[4], float* __restrict__ o1,
                                                float* __restrict__ o2) {
  const int tid = threadIdx.x;
  const int tn = tid % 16, tm = tid / 16;
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
    atomicAdd(o1 + tid, a);
    atomicAdd(o2 + tid, q);
  }
}

constexpr size_t RED_BYTES_H = 2ull * 4 * TN * 4;
constexpr size_t RED_BYTES_F = 2ull * 16 * TN * 4;

}  // namespace xv
