// 3x3 SAME stride-1 convolution for small channel counts (C, Co in 8..64,
// multiples of 8) at high resolution, and its weight gradient.
//
// small_conv_fwd replaces the TPU kernel ops/pallas_conv.py::_conv_kernel
// (_conv3x3_fwd_impl):
//   out[b, y, x, o] = sum_{dy, dx, k} x[b, y+dy-1, x+dx-1, k] * kmat[(dy, dx, k), o]
// with a zero halo, f32 accumulation and the output in x's type.  The same
// kernel computes dL/dx when it is given the cotangent and the flipped,
// IO-transposed kernel.
//
// small_conv_wgrad replaces ops/pallas_conv.py::_wgrad_kernel
// (_conv3x3_wgrad_impl):
//   dW[(dy, dx, k), o] = sum_{b, y, x} x[b, y+dy-1, x+dx-1, k] * g[b, y, x, o]
// as a (9C, Co) FLOAT32 matrix.
//
// Bound on the H100: bytes for both.  Per pixel the work is 18*C*Co FLOP
// against (C + Co) elements moved; at C = Co = 32 in bf16 that is 144 FLOP per
// byte, below the card's 295.
//
// Design (simple and right first):
//  * The TPU kernel builds an (8W, 9C) im2col block in VMEM from two stacked
//    8-row views and multiplies it by the (9C, Co) matrix; its cost there is
//    the relayout into the matmul operand.  Here nothing is relaid out: the
//    nine taps of a staged row are the same shared-memory tile read at a
//    one-pixel offset.
//  * forward, bf16: a block owns 128 pixels of FWD_ROWS consecutive rows.
//    ALL 9C x Co weights are staged once per block (at most 83 KB with the
//    padding) and the input rows go through a ring of three row slots, so
//    each input row is staged once per block, not three times.  Each warp
//    owns 16 pixels x all output channels as up to four 16x16 wmma f32
//    accumulators.  Channels are padded with zeros to multiples of 16 in
//    shared memory only (the domain's step is 8, wmma's is 16).
//  * forward, f32: plain FMA (no TF32).  A thread owns one pixel and half of
//    the output channels; the weights are read through the read-only cache as
//    warp-wide broadcasts (in f32 they do not fit beside the rows).
//  * wgrad: the TPU kernel adds into one resident output over a sequential
//    grid.  Here the B*H*W pixels are SPLIT over blocks (about four per SM).
//    bf16: the (9C, Co) output is cut into (9 taps x 16 x 16) warp tiles, at
//    most 16 of them; a block's 8 warps take the tiles, and where there are
//    fewer tiles than warps the spare warps take other 16-pixel steps of the
//    same staged segment.  A^T comes from the staged rows as a col-major
//    fragment at the tap's pixel offset.  f32: 9 x 4 FMA accumulators per
//    thread.  Each block adds its part into the ZEROED output with f32
//    atomicAdd, whose order changes from run to run: dW is reproducible to
//    f32 sum-order noise (the callers compare at 1e-3 of max |dW|).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int TM = 128;       // pixels (along W) per block segment, 16 per warp
constexpr int AW = TM + 2;    // staged input columns (with halo)
constexpr int FWD_ROWS = 16;  // output rows per forward block

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Row stride (in bf16 elements) of a staged pixel with cp channels: a multiple
// of 16 (every wmma fragment pointer stays 32-byte aligned) that is not a
// multiple of 64 (128 bytes would put every pixel on the same banks).
inline int lda_bf16(int cp) { return (cp + 16) % 64 == 0 ? cp + 32 : cp + 16; }

// ------------------------------------------------------------ forward, bf16

// Stage input row yy (may be -1 or h: zeros), columns x0-1 .. x0+TM, into the
// ring slot (yy + 1) % 3 as As[(slot*AW + j)*lda + k], channels >= c zero.
__device__ __forceinline__ void stage_row_bf16(bf16* __restrict__ As, const bf16* __restrict__ x,
                                               int b, int yy, int x0, int h, int w, int c, int cp,
                                               int lda) {
  const int kvn = cp / 8;
  bf16* dst = As + ((yy + 1) % 3) * AW * lda;
  for (int v = threadIdx.x; v < AW * kvn; v += THREADS) {
    const int kv = v % kvn;
    const int j = v / kvn;
    const int xx = x0 + j - 1;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (yy >= 0 && yy < h && xx >= 0 && xx < w && kv * 8 < c)
      val = *reinterpret_cast<const uint4*>(x + (((size_t)b * h + yy) * w + xx) * c + kv * 8);
    *reinterpret_cast<uint4*>(dst + j * lda + kv * 8) = val;
  }
}

template <int NT>  // 16-wide output channel tiles: Co padded to NT * 16
__global__ void __launch_bounds__(THREADS) small_fwd_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ kmat, bf16* __restrict__ out, int h,
    int w, int c, int co, int cp, int lda, int row_groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int COP = NT * 16;
  constexpr int LDB = COP + 8;  // halves; 16 rows stay a multiple of 32 bytes
  constexpr int LDC = COP + 4;  // floats
  bf16* Bs = reinterpret_cast<bf16*>(smem);  // (9*cp, LDB)
  const size_t b_bytes = align128((size_t)9 * cp * LDB * 2);
  bf16* As = reinterpret_cast<bf16*>(smem + b_bytes);  // ring (3, AW, lda)
  const size_t a_bytes = align128((size_t)3 * AW * lda * 2);
  float* Cs = reinterpret_cast<float*>(smem + b_bytes + a_bytes);  // (TM, LDC)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / row_groups;
  const int y0 = (blockIdx.x - b * row_groups) * FWD_ROWS;
  const int x0 = blockIdx.y * TM;
  const int y_end = min(y0 + FWD_ROWS, h);

  // all the weights, once per block; padded rows and columns are zero
  constexpr int NV = COP / 8;
  for (int v = tid; v < 9 * cp * NV; v += THREADS) {
    const int nv = v % NV;
    const int k = (v / NV) % cp;
    const int t = v / NV / cp;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k < c && nv * 8 < co)
      val = *reinterpret_cast<const uint4*>(kmat + ((size_t)t * c + k) * co + nv * 8);
    *reinterpret_cast<uint4*>(Bs + (t * cp + k) * LDB + nv * 8) = val;
  }
  stage_row_bf16(As, x, b, y0 - 1, x0, h, w, c, cp, lda);
  stage_row_bf16(As, x, b, y0, x0, h, w, c, cp, lda);

  const int nvec = co / 8;
  for (int y = y0; y < y_end; ++y) {
    stage_row_bf16(As, x, b, y + 1, x0, h, w, c, cp, lda);  // into the slot of row y - 2
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const bf16* rowp = As + ((y + dy) % 3) * AW * lda;  // row y + dy - 1
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int t = dy * 3 + dx;
        for (int ks = 0; ks < cp / 16; ++ks) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::load_matrix_sync(af, rowp + (warp * 16 + dx) * lda + ks * 16, lda);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, Bs + (t * cp + ks * 16) * LDB + j * 16, LDB);
            wmma::mma_sync(acc[j], af, bfr, acc[j]);
          }
        }
      }
    }
    // each warp writes and reads only its own 16 rows of Cs
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::store_matrix_sync(Cs + (warp * 16) * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * nvec; e += 32) {
      const int r = e / nvec;
      const int nv = e % nvec;
      const int px = x0 + warp * 16 + r;
      if (px < w) {
        const float* src = Cs + (warp * 16 + r) * LDC + nv * 8;
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        uint4 packed;
        bf16* e8 = reinterpret_cast<bf16*>(&packed);
        e8[0] = __float2bfloat16(lo.x);
        e8[1] = __float2bfloat16(lo.y);
        e8[2] = __float2bfloat16(lo.z);
        e8[3] = __float2bfloat16(lo.w);
        e8[4] = __float2bfloat16(hi.x);
        e8[5] = __float2bfloat16(hi.y);
        e8[6] = __float2bfloat16(hi.z);
        e8[7] = __float2bfloat16(hi.w);
        *reinterpret_cast<uint4*>(out + (((size_t)b * h + y) * w + px) * co + nv * 8) = packed;
      }
    }
    __syncthreads();  // row y - 1's slot and Cs are free for the next row
  }
}

// ------------------------------------------------------------- forward, f32

__device__ __forceinline__ void stage_row_f32(float* __restrict__ As, const float* __restrict__ x,
                                              int b, int yy, int x0, int h, int w, int c, int c0,
                                              int cb, int lda, int aw, int slot) {
  const int kvn = cb / 4;
  float* dst = As + slot * aw * lda;
  for (int v = threadIdx.x; v < aw * kvn; v += THREADS) {
    const int kv = v % kvn;
    const int j = v / kvn;
    const int xx = x0 + j - 1;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (yy >= 0 && yy < h && xx >= 0 && xx < w && c0 + kv * 4 < c)
      val = *reinterpret_cast<const float4*>(x + (((size_t)b * h + yy) * w + xx) * c + c0 + kv * 4);
    float* d = dst + j * lda + kv * 4;  // lda is odd: scalar stores
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

__global__ void __launch_bounds__(THREADS) small_fwd_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ kmat, float* __restrict__ out, int h,
    int w, int c, int co, int row_groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // ring (3, AW, lda)
  const int lda = c + 1;                       // odd: neighbouring pixels on different banks

  const int tid = threadIdx.x;
  const int p = tid % TM;          // this thread's pixel of the segment
  const int base = (tid / TM) * (co / 2);  // and its half of the output channels
  const int nq = co / 8;           // float4 groups per thread (1..8)
  const int b = blockIdx.x / row_groups;
  const int y0 = (blockIdx.x - b * row_groups) * FWD_ROWS;
  const int x0 = blockIdx.y * TM;
  const int y_end = min(y0 + FWD_ROWS, h);

  stage_row_f32(As, x, b, y0 - 1, x0, h, w, c, 0, c, lda, AW, y0 % 3);
  stage_row_f32(As, x, b, y0, x0, h, w, c, 0, c, lda, AW, (y0 + 1) % 3);
  for (int y = y0; y < y_end; ++y) {
    stage_row_f32(As, x, b, y + 1, x0, h, w, c, 0, c, lda, AW, (y + 2) % 3);
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      const float* rowp = As + ((y + dy) % 3) * AW * lda;  // row y + dy - 1
      for (int dx = 0; dx < 3; ++dx) {
        const float* arow = rowp + (p + dx) * lda;
        const float* wbase = kmat + (size_t)(dy * 3 + dx) * c * co + base;
        for (int k = 0; k < c; ++k) {
          const float a = arow[k];
          const float4* wv = reinterpret_cast<const float4*>(wbase + (size_t)k * co);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (q < nq) {
              const float4 wq = __ldg(wv + q);
              acc[q][0] = fmaf(a, wq.x, acc[q][0]);
              acc[q][1] = fmaf(a, wq.y, acc[q][1]);
              acc[q][2] = fmaf(a, wq.z, acc[q][2]);
              acc[q][3] = fmaf(a, wq.w, acc[q][3]);
            }
          }
        }
      }
    }
    const int px = x0 + p;
    if (px < w) {
      float* o = out + (((size_t)b * h + y) * w + px) * co + base;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < nq)
          *reinterpret_cast<float4*>(o + 4 * q) =
              make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    }
    __syncthreads();  // row y - 1's slot is free for the next row
  }
}

// -------------------------------------------------------------- wgrad, bf16

__global__ void __launch_bounds__(THREADS) small_wgrad_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ out, int bsz,
    int h, int w, int c, int co, int cp, int cop, int lda, int tiles_per_block, int segs,
    int tasks_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldg = cop + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);  // (3, AW, lda)
  const size_t a_bytes = align128((size_t)3 * AW * lda * 2);
  bf16* Gs = reinterpret_cast<bf16*>(smem + a_bytes);  // (TM, ldg)
  const size_t g_bytes = align128((size_t)TM * ldg * 2);
  float* patch = reinterpret_cast<float*>(smem + a_bytes + g_bytes);  // one 16x16 per warp

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_co = cop / 16;
  const int n_tiles = (cp / 16) * n_co;
  const int groups = (THREADS / 32) / tiles_per_block;  // warps sharing one tile
  const int group = warp / tiles_per_block;
  const int tile = blockIdx.y * tiles_per_block + warp % tiles_per_block;
  const bool active = group < groups && tile < n_tiles;  // uniform within a warp
  const int ci = tile / n_co;   // which 16 input channels
  const int coj = tile % n_co;  // which 16 output channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wmma::fill_fragment(acc[t], 0.f);

  const int kvn = cp / 8, gvn = cop / 8;
  const int total = bsz * h * segs;
  const int first = blockIdx.x * tasks_per_block;
  const int last = min(first + tasks_per_block, total);
  for (int task = first; task < last; ++task) {
    const int b = task / (h * segs);
    const int rem = task - b * h * segs;
    const int y = rem / segs;
    const int x0 = (rem - y * segs) * TM;
    __syncthreads();  // the previous segment's reads are done
    for (int v = tid; v < 3 * AW * kvn; v += THREADS) {
      const int kv = v % kvn;
      const int j = (v / kvn) % AW;
      const int dy = v / kvn / AW;
      const int yy = y + dy - 1, xx = x0 + j - 1;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (yy >= 0 && yy < h && xx >= 0 && xx < w && kv * 8 < c)
        val = *reinterpret_cast<const uint4*>(x + (((size_t)b * h + yy) * w + xx) * c + kv * 8);
      *reinterpret_cast<uint4*>(As + (dy * AW + j) * lda + kv * 8) = val;
    }
    for (int v = tid; v < TM * gvn; v += THREADS) {
      const int nv = v % gvn;
      const int p = v / gvn;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (x0 + p < w && nv * 8 < co)
        val = *reinterpret_cast<const uint4*>(g + (((size_t)b * h + y) * w + x0 + p) * co + nv * 8);
      *reinterpret_cast<uint4*>(Gs + p * ldg + nv * 8) = val;
    }
    __syncthreads();
    if (active) {
      for (int ks = group; ks < TM / 16; ks += groups) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gf;
        wmma::load_matrix_sync(gf, Gs + (ks * 16) * ldg + coj * 16, ldg);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            // A^T: element (channel i, pixel k) at As[(row + k) * lda + i]
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
            wmma::load_matrix_sync(af, As + (dy * AW + ks * 16 + dx) * lda + ci * 16, lda);
            wmma::mma_sync(acc[dy * 3 + dx], af, gf, acc[dy * 3 + dx]);
          }
        }
      }
    }
  }

  if (active) {
    float* mine = patch + warp * 256;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      wmma::store_matrix_sync(mine, acc[t], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = lane + 32 * i;
        const int cc = ci * 16 + idx / 16;
        const int oo = coj * 16 + idx % 16;
        if (cc < c && oo < co) atomicAdd(out + ((size_t)t * c + cc) * co + oo, mine[idx]);
      }
      __syncwarp();
    }
  }
}

// --------------------------------------------------------------- wgrad, f32

constexpr int WF_TM = 64;          // pixels per staged segment
constexpr int WF_AW = WF_TM + 2;

// Thread (ch, q) = (tid / qn, tid % qn) with qn = co / 4 owns input channel
// c0 + ch and output channels q*4 .. q*4+3 over all nine taps; a block covers
// chb input channels.
__global__ void __launch_bounds__(THREADS) small_wgrad_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ out, int bsz,
    int h, int w, int c, int co, int chb, int segs, int tasks_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = chb + 1;
  float* As = reinterpret_cast<float*>(smem);  // (3, WF_AW, lda)
  float* Gs = reinterpret_cast<float*>(smem + align128((size_t)3 * WF_AW * lda * 4));  // (WF_TM, co)

  const int tid = threadIdx.x;
  const int qn = co / 4;
  const int q = tid % qn;
  const int ch = tid / qn;
  const int c0 = blockIdx.y * chb;
  const bool active = ch < chb && c0 + ch < c;
  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;

  const int total = bsz * h * segs;
  const int first = blockIdx.x * tasks_per_block;
  const int last = min(first + tasks_per_block, total);
  for (int task = first; task < last; ++task) {
    const int b = task / (h * segs);
    const int rem = task - b * h * segs;
    const int y = rem / segs;
    const int x0 = (rem - y * segs) * WF_TM;
    __syncthreads();
    for (int dy = 0; dy < 3; ++dy)
      stage_row_f32(As, x, b, y + dy - 1, x0, h, w, c, c0, chb, lda, WF_AW, dy);
    for (int v = tid; v < WF_TM * qn; v += THREADS) {
      const int nv = v % qn;
      const int p = v / qn;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (x0 + p < w)
        val = *reinterpret_cast<const float4*>(g + (((size_t)b * h + y) * w + x0 + p) * co + nv * 4);
      *reinterpret_cast<float4*>(Gs + p * co + nv * 4) = val;
    }
    __syncthreads();
    if (active) {
      for (int p = 0; p < WF_TM; ++p) {
        const float4 gv = *reinterpret_cast<const float4*>(Gs + p * co + q * 4);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float a = As[(dy * WF_AW + p + dx) * lda + ch];
            const int t = dy * 3 + dx;
            acc[t][0] = fmaf(a, gv.x, acc[t][0]);
            acc[t][1] = fmaf(a, gv.y, acc[t][1]);
            acc[t][2] = fmaf(a, gv.z, acc[t][2]);
            acc[t][3] = fmaf(a, gv.w, acc[t][3]);
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      float* dst = out + ((size_t)t * c + c0 + ch) * co + q * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(dst + j, acc[t][j]);
    }
  }
}

// ------------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NT>
cudaError_t launch_fwd_bf16(const void* x, const void* kmat, void* out, int b, int h, int w, int c,
                            int co, cudaStream_t stream) {
  const int cp = (c + 15) / 16 * 16;
  const int lda = lda_bf16(cp);
  const size_t smem = align128((size_t)9 * cp * (NT * 16 + 8) * 2) +
                      align128((size_t)3 * AW * lda * 2) + (size_t)TM * (NT * 16 + 4) * 4;
  cudaError_t err = allow_smem(small_fwd_bf16_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  const int row_groups = (h + FWD_ROWS - 1) / FWD_ROWS;
  const dim3 grid((unsigned)(b * row_groups), (unsigned)((w + TM - 1) / TM));
  small_fwd_bf16_kernel<NT><<<grid, THREADS, smem, stream>>>((const bf16*)x, (const bf16*)kmat,
                                                       (bf16*)out, h, w, c, co, cp, lda,
                                                       row_groups);
  return cudaGetLastError();
}

// About four blocks per SM in all, each with a contiguous range of segments.
cudaError_t split_tasks(long long total, int tiles_y, int* per, unsigned* blocks_x) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long splits = (4LL * sms + tiles_y - 1) / tiles_y;
  if (splits < 1) splits = 1;
  if (splits > total) splits = total;
  *per = (int)((total + splits - 1) / splits);
  *blocks_x = (unsigned)((total + *per - 1) / *per);
  return cudaSuccess;
}

}  // namespace

// x: (b, h, w, c) contiguous; kmat: (9c, co) contiguous, x's dtype, rows
// (dy, dx, c); out: (b, h, w, co) in x's dtype.  c and co in 8..64, multiples
// of 8.  dtype 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int small_conv_fwd(const void* x, const void* kmat, void* out, int b, int h, int w,
                              int c, int co, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 8 || co % 8 || c < 8 || co < 8 || c > 64 || co > 64) return (int)cudaErrorInvalidValue;
  if ((long long)b * h * w <= 0) return (int)cudaSuccess;
  if (dtype == 1) {
    switch ((co + 15) / 16) {
      case 1: return (int)launch_fwd_bf16<1>(x, kmat, out, b, h, w, c, co, s);
      case 2: return (int)launch_fwd_bf16<2>(x, kmat, out, b, h, w, c, co, s);
      case 3: return (int)launch_fwd_bf16<3>(x, kmat, out, b, h, w, c, co, s);
      default: return (int)launch_fwd_bf16<4>(x, kmat, out, b, h, w, c, co, s);
    }
  }
  if (dtype == 0) {
    const size_t smem = (size_t)3 * AW * (c + 1) * 4;
    cudaError_t err = allow_smem(small_fwd_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int row_groups = (h + FWD_ROWS - 1) / FWD_ROWS;
    const dim3 grid((unsigned)(b * row_groups), (unsigned)((w + TM - 1) / TM));
    small_fwd_f32_kernel<<<grid, THREADS, smem, s>>>((const float*)x, (const float*)kmat, (float*)out, h,
                                               w, c, co, row_groups);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// x: (b, h, w, c) and g: (b, h, w, co), contiguous, same dtype; out: (9c, co)
// f32, ZEROED by the caller.  c and co in 8..64, multiples of 8.  dtype 0 =
// float32, 1 = bfloat16.
extern "C" int small_conv_wgrad(const void* x, const void* g, void* out, int b, int h, int w,
                                int c, int co, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 8 || co % 8 || c < 8 || co < 8 || c > 64 || co > 64) return (int)cudaErrorInvalidValue;
  if ((long long)b * h * w <= 0) return (int)cudaSuccess;
  int per = 0;
  unsigned blocks_x = 0;
  if (dtype == 1) {
    const int cp = (c + 15) / 16 * 16, cop = (co + 15) / 16 * 16;
    const int lda = lda_bf16(cp);
    const int n_tiles = (cp / 16) * (cop / 16);
    const int tiles_y = (n_tiles + 7) / 8;
    const int tiles_per_block = (n_tiles + tiles_y - 1) / tiles_y;
    const int segs = (w + TM - 1) / TM;
    const size_t smem = align128((size_t)3 * AW * lda * 2) +
                        align128((size_t)TM * (cop + 8) * 2) + (size_t)8 * 256 * 4;
    cudaError_t err = allow_smem(small_wgrad_bf16_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    err = split_tasks((long long)b * h * segs, tiles_y, &per, &blocks_x);
    if (err != cudaSuccess) return (int)err;
    small_wgrad_bf16_kernel<<<dim3(blocks_x, (unsigned)tiles_y), THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)g, (float*)out, b, h, w, c, co, cp, cop, lda, tiles_per_block,
        segs, per);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const int qn = co / 4;
    int chb = (THREADS / qn) & ~3;  // input channels per block, a multiple of 4
    if (chb > c) chb = c;
    const int tiles_y = (c + chb - 1) / chb;
    const int segs = (w + WF_TM - 1) / WF_TM;
    const size_t smem = align128((size_t)3 * WF_AW * (chb + 1) * 4) + (size_t)WF_TM * co * 4;
    cudaError_t err = allow_smem(small_wgrad_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    err = split_tasks((long long)b * h * segs, tiles_y, &per, &blocks_x);
    if (err != cudaSuccess) return (int)err;
    small_wgrad_f32_kernel<<<dim3(blocks_x, (unsigned)tiles_y), THREADS, smem, s>>>(
        (const float*)x, (const float*)g, (float*)out, b, h, w, c, co, chb, segs, per);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
