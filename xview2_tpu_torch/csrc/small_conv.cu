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
// byte, below the card's 295.  At (16, 512, 512, 32) -> 32 the forward moves
// 537 MB (0.160 ms at 3.35 TB/s) and does 77 GFLOP (0.078 ms at the dense
// bf16 peak), so the product fits under the copies only if it overlaps them.
//
// Design:
//  * The TPU kernel builds an (8W, 9C) im2col block in VMEM from two stacked
//    8-row views and multiplies it by the (9C, Co) matrix; its cost there is
//    the relayout into the matmul operand.  Here nothing is relaid out: the
//    nine taps of a staged row are the same shared-memory row read at a
//    one-pixel offset (a pointer offset for ldmatrix).
//  * forward, bf16 (small_fwd_mma_kernel, every bf16 shape of the domain):
//    persistent blocks of 256 threads, as many as fit on the SMs, walk pairs
//    of output rows of a column segment (256 pixels at C <= 32, else 128, plus
//    a one-pixel halo on each side), each block a contiguous range of them,
//    so the halo rows are read once per band of pairs, not once per pass.
//    Input rows go through a ring of eight row slots filled by cp.async (16
//    bytes a copy; zero fill makes the SAME halo and pads C to a multiple of
//    16): a pass's two new rows are issued two passes before it, so four rows
//    are in flight while the tensor cores work on the four rows of the
//    current pass, and there is one barrier per two output rows.  The pixel
//    stride is 2*CP + 16 bytes, an odd number of 16-byte groups, so ldmatrix
//    of eight pixels is free of bank conflicts at each of the three dx
//    offsets.  The weights are read once per block and held for its life as
//    mma.sync B fragments in registers (9 taps x KS k-steps x NW n8 tiles x
//    2, at most 144 registers: a warp owns NW n8 tiles of the output
//    channels and the block's warps split Co into groups).  Each warp multiplies 16
//    pixels of BOTH output rows with mma.sync.m16n8k16: an A fragment of an
//    input row serves tap row dy of the first output row and dy - 1 of the
//    second.  The epilogue converts the f32 accumulators to bf16 pairs and
//    hands each lane 8 whole channels by a quad transpose: one 16-byte store a
//    lane, no round trip through shared memory.  Each output element is
//    summed by one thread in a fixed order: bit-equal between runs.
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

#include "conv_mma.cuh"

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
//
// Persistent blocks walk pairs of output rows.  The work is a list of units
// (image, column segment, row pair), ordered so that the pairs of one segment
// follow each other; block i takes the i-th of gridDim.x equal contiguous
// ranges of it.  Inside a range, each run of pairs of one segment is a band:
// its input rows pass once through a ring of F_SLOTS row slots filled by
// cp.async, two rows a pass, issued two passes before the pass that first
// reads them.
constexpr int F_SLOTS = 8;       // input rows in the ring: 4 in use, 4 in flight
constexpr int F_SEG_WIDE = 256;  // output pixels per row segment at C <= 32
constexpr int F_SEG_NARROW = 128;  // ... above (a row slot of 64 channels is 2.3x larger)
// registers per thread for the weights' B fragments: 144 lets a warp own all
// 32 output channels at C = 32, which halves the ldmatrix of A against 72
// (4% faster at the smoke's shape: kernel_ab.py small)
constexpr int F_BREG = 144;

// bytes per staged pixel: 2 * CP + 16 is an odd multiple of 16, so the eight
// rows of an ldmatrix (eight neighbouring pixels) fall on eight bank groups
__host__ __device__ constexpr int f_ldp(int cp) { return 2 * cp + 16; }
__host__ __device__ inline int f_seg(int cp, int w) {
  const int seg_max = cp <= 32 ? F_SEG_WIDE : F_SEG_NARROW;
  const int w16 = (w + 15) / 16 * 16;
  return w16 < seg_max ? w16 : seg_max;
}
// n8 tiles of output channels a warp owns: a power of two, at most F_BREG /
// (18 KS) (its 9 x KS x NW x 2 B registers), no more than Co needs
__host__ __device__ constexpr int f_nw_max(int ks) {
  return F_BREG / (18 * ks) >= 4 ? 4 : F_BREG / (18 * ks) >= 2 ? 2 : 1;
}
inline int f_nw(int ks, int nt8) {
  int nw = 1;
  while (nw < f_nw_max(ks) && nw < nt8) nw *= 2;
  return nw;
}

// KS: 16-channel k-steps (C padded to CP = 16 KS); NW: n8 tiles per warp.
// Warp w owns channel group w % G (G = ceil(Co / 8 / NW)) and takes the
// 16-pixel groups w / G, w / G + 8 / G, ... of each pass, both output rows.
template <int KS, int NW>
__global__ void __launch_bounds__(THREADS, 1) small_fwd_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ kmat, bf16* __restrict__ out, int h,
    int w, int c, int co, int seg, int segs, int hp, long long units) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CP = KS * 16;
  constexpr int LDP = f_ldp(CP);
  constexpr int PPP = CP / 8;  // 16-byte pieces per staged pixel
  const int slot_bytes = (seg + 2) * LDP;
  const uint32_t sbase = xv::mm::smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int nt8 = co / 8;
  const int groups = (nt8 + NW - 1) / NW;
  const int nwp = (THREADS / 32) / groups;  // warps per channel group
  const int cg = warp % groups, wi = warp / groups;
  const int nt_mine = min(NW, nt8 - cg * NW);  // this warp's n8 tiles that hold channels

  // the weights as B fragments, for the block's life: tap tp, k-step s, n8
  // tile t: rows 16s + 2q, +1 (word 0) and +8, +9 (word 1) of column 8(cg NW
  // + t) + g; channels past C and Co are zero
  uint32_t bfr[9][KS][NW][2];
#pragma unroll
  for (int tp = 0; tp < 9; ++tp)
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int t = 0; t < NW; ++t)
#pragma unroll
        for (int hw = 0; hw < 2; ++hw) {
          const int k = 16 * s + 2 * q + 8 * hw, n = 8 * (cg * NW + t) + g;
          __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
          if (k < c && n < co)  // c is a multiple of 8, so k + 1 < c too
            v = __halves2bfloat162(kmat[((size_t)tp * c + k) * co + n],
                                   kmat[((size_t)tp * c + k + 1) * co + n]);
          bfr[tp][s][t][hw] = *reinterpret_cast<const uint32_t*>(&v);
        }

  // ldmatrix: lane -> pixel row of the 16 and 8-channel half of a k-step
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off = (uint32_t)(lrow * LDP + (lane >> 4) * 16);
  const int per_row = (seg + 2) * PPP;

  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  for (long long u = units * blockIdx.x / gridDim.x; u < u_end;) {
    const long long band = u / hp;  // (image, segment)
    const int p0 = (int)(u - band * hp);
    const long long band_end = (band + 1) * hp < u_end ? (band + 1) * hp : u_end;
    const int np = (int)(band_end - u);
    const int bi = (int)(band / segs);
    const int x0 = (int)(band - (long long)bi * segs) * seg;
    const size_t img = (size_t)bi * h;

    // input rows 2 p0 - 1 + j, j = j0 .. j0 + nrows - 1, into slots j % F_SLOTS;
    // zeros outside the image and past C
    auto load_rows = [&](int j0, int nrows) {
      for (int v = tid; v < nrows * per_row; v += THREADS) {
        const int rr = v / per_row;
        const int rem = v - rr * per_row;
        const int jx = rem / PPP, pc = rem - (rem / PPP) * PPP;
        const int j = j0 + rr;
        const int y = 2 * p0 - 1 + j, xx = x0 + jx - 1;
        const bool in = y >= 0 && y < h && xx >= 0 && xx < w && pc * 8 < c;
        const bf16* src = in ? x + ((img + y) * w + xx) * c + pc * 8 : x;
        xv::mm::cp_async16(sbase + (uint32_t)((j % F_SLOTS) * slot_bytes + jx * LDP + pc * 16),
                           src, in);
      }
    };
    load_rows(0, 4);  // pass 0
    xv::mm::cp_async_commit();
    if (np > 1) load_rows(4, 2);  // pass 1
    xv::mm::cp_async_commit();

    for (int k = 0; k < np; ++k) {
      xv::mm::cp_async_wait<1>();  // this thread's pieces of rows 2k .. 2k + 3 have landed
      // every piece has; every warp is done with pass k - 1, whose first two
      // rows' slots the next copies refill
      __syncthreads();
      if (k + 2 < np) load_rows(2 * k + 6, 2);  // pass k + 2's new rows
      xv::mm::cp_async_commit();
      if (wi >= nwp) continue;

      uint32_t slot[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        slot[r] = sbase + (uint32_t)(((2 * k + r) % F_SLOTS) * slot_bytes) + a_off;
      const int y0 = 2 * (p0 + k);
      for (int it = wi; it < seg / 16; it += nwp) {
        // acc[r][t]: output row y0 + r, pixels 16 it + g (+8), channels of tile t
        float acc[2][NW][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int t = 0; t < NW; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][t][e] = 0.f;
        // input row ir feeds tap row ir of output row y0 and ir - 1 of y0 + 1
#pragma unroll
        for (int ir = 0; ir < 4; ++ir) {
          const uint32_t rbase = slot[ir] + (uint32_t)(it * 16 * LDP);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int s = 0; s < KS; ++s) {
              uint32_t a[4];
              xv::mm::ldmatrix_x4(a, rbase + (uint32_t)(dx * LDP + s * 32));
              // no run-time test in here: a branch among the MMAs keeps the
              // compiler from running the ldmatrix of the next step ahead (a
              // tile past Co has zero B fragments and is not stored)
#pragma unroll
              for (int t = 0; t < NW; ++t) {
                if (ir < 3) xv::mm::mma_m16n8k16_bf16(acc[0][t], a, bfr[ir * 3 + dx][s][t]);
                if (ir > 0) xv::mm::mma_m16n8k16_bf16(acc[1][t], a, bfr[(ir - 1) * 3 + dx][s][t]);
              }
            }
        }
        // straight from the accumulators: word i = (2 r + hh) NW + t holds
        // channels 8t + 2q, +1 of pixel g + 8 hh of row r as a bf16 pair.  A
        // quad transpose of four words hands lane q word 4 gi + q whole: one
        // 16-byte store of 8 channels a lane.
#pragma unroll
        for (int gi = 0; gi < NW; ++gi) {
          uint32_t v[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int i = 4 * gi + kk;
            const int r = i / (2 * NW), hh = (i / NW) % 2, t = i % NW;
            const __nv_bfloat162 pr =
                __floats2bfloat162_rn(acc[r][t][2 * hh], acc[r][t][2 * hh + 1]);
            v[kk] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          xv::mm::quad_transpose(v, q);
          const int i = 4 * gi + q;
          const int r = i / (2 * NW), hh = (i / NW) % 2, t = i % NW;
          const int y = y0 + r, xg = x0 + it * 16 + g + 8 * hh;
          if (y < h && xg < w && t < nt_mine)
            *reinterpret_cast<uint4*>(out + ((img + y) * w + xg) * co + 8 * (cg * NW + t)) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    xv::mm::cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next band
    u = band_end;
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

template <int KS, int NW>
cudaError_t launch_fwd_mma(const void* x, const void* kmat, void* out, int b, int h, int w, int c,
                           int co, cudaStream_t stream) {
  const int seg = f_seg(KS * 16, w);
  const int segs = (w + seg - 1) / seg, hp = (h + 1) / 2;
  const size_t smem = (size_t)F_SLOTS * (seg + 2) * f_ldp(KS * 16);
  auto kern = small_fwd_mma_kernel<KS, NW>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem)) !=
      cudaSuccess)
    return err;
  const long long units = (long long)b * segs * hp;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > units) blocks = units;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>((const bf16*)x, (const bf16*)kmat, (bf16*)out,
                                                    h, w, c, co, seg, segs, hp, units);
  return cudaGetLastError();
}

template <int KS>
cudaError_t fwd_mma(const void* x, const void* kmat, void* out, int b, int h, int w, int c, int co,
                    cudaStream_t s) {
  constexpr int NW_MAX = f_nw_max(KS);
  switch (f_nw(KS, co / 8)) {
    case 1: return launch_fwd_mma<KS, 1>(x, kmat, out, b, h, w, c, co, s);
    case 2:
      if constexpr (NW_MAX >= 2) return launch_fwd_mma<KS, 2>(x, kmat, out, b, h, w, c, co, s);
      return cudaErrorInvalidValue;
    default:
      if constexpr (NW_MAX >= 4) return launch_fwd_mma<KS, 4>(x, kmat, out, b, h, w, c, co, s);
      return cudaErrorInvalidValue;
  }
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
    switch ((c + 15) / 16) {
      case 1: return (int)fwd_mma<1>(x, kmat, out, b, h, w, c, co, s);
      case 2: return (int)fwd_mma<2>(x, kmat, out, b, h, w, c, co, s);
      case 3: return (int)fwd_mma<3>(x, kmat, out, b, h, w, c, co, s);
      default: return (int)fwd_mma<4>(x, kmat, out, b, h, w, c, co, s);
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
