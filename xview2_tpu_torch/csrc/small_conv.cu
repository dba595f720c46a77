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
//    grid.  bf16 (small_wgrad_mma_kernel): the forward's persistent walk over
//    bands of row pairs of one column segment (128 pixels where eight slots
//    fit, else 64), but each ring slot holds an input row AND the cotangent
//    row of the same index, both by 16-byte cp.async with zero fill; a pass's
//    two new rows are issued two passes ahead, so each x and g row crosses
//    from L2 once per band (plus the band's two x halo rows).  The pixels are
//    the reduction dimension of mma.sync.m16n8k16: A = x^T (16 channels x 16
//    pixels) by ldmatrix.trans at the tap's one-pixel offset, B = g (16
//    pixels x 8 output channels) by ldmatrix.trans, both at the forward's
//    conflict-free pixel stride.  One A fragment of input row r at offset dx
//    feeds taps (dy, dx) of the two output rows of the pass that read it.  A
//    warp owns one 16-channel input tile x WN 16-channel output tiles over all
//    nine taps (72 WN f32 registers, held for the block's life); copies of
//    those roles split the pixel steps where Co * C is small.  No atomics:
//    each block adds its warps' copies in a fixed order and writes its partial
//    (9C, Co) to its own workspace slot, and small_wgrad_sum_kernel adds the
//    slots in a fixed order.  For a given card (the grid is its SM count) dW is
//    bit-equal between runs; against the plain version it differs by the f32
//    order of the sums (the callers compare at 1e-3 of max |dW|).
//    f32 (small_wgrad_f32_kernel): 9 x 4 FMA accumulators per thread over
//    pixels split about four blocks per SM, added with f32 atomicAdd into the
//    output that the entry point zeroes first: reproducible only to f32
//    sum-order noise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int TM = 128;       // pixels (along W) per block segment, 16 per warp
constexpr int AW = TM + 2;    // staged input columns (with halo)
constexpr int FWD_ROWS = 16;  // output rows per forward block

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

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
//
// The forward's units and walk: block i takes the i-th of gridDim.x equal
// contiguous ranges of (image, column segment, row pair), and each run of
// pairs of one segment is a band.  Ring row j of a band starting at pair p0
// holds input row 2 p0 - 1 + j and cotangent row 2 p0 - 1 + j side by side in
// slot j % W_SLOTS; pass k reads the input rows of j = 2k .. 2k + 3 and the
// cotangent rows of j = 2k + 1, 2k + 2 (output rows 2 (p0 + k), + 1).  The
// cotangent rows of the band's two halo rows (j = 0 and 2 np + 1) are not
// staged.
constexpr int W_SLOTS = 8;             // ring rows: 4 in use, 4 in flight
constexpr int W_SEG = 128;             // pixels per row segment where 8 slots fit, else 64
constexpr int SMEM_OPTIN = 232448;     // dynamic shared memory a block may opt in to (sm_90)

// bytes of a ring slot: the input row with its halo, then the cotangent row
__host__ __device__ inline int w_slot_bytes(int seg, int cp, int cop) {
  return (seg + 2) * f_ldp(cp) + seg * f_ldp(cop);
}
inline int w_seg(int cp, int cop, int w) {
  const int seg_max = W_SLOTS * w_slot_bytes(W_SEG, cp, cop) <= SMEM_OPTIN ? W_SEG : W_SEG / 2;
  const int w16 = (w + 15) / 16 * 16;
  return w16 < seg_max ? w16 : seg_max;
}
// warp roles: one 16-channel tile of the input channels x WN 16-channel tiles
// of the output channels, all nine taps; the block's 8 warps form `groups`
// copies of the roles, which split the 16-pixel steps of each pass
__host__ __device__ inline int w_roles(int cp, int cop, int wn) {
  return (cp / 16) * ((cop / 16 + wn - 1) / wn);
}

// WN: 16-channel output tiles per warp (2 wherever Co > 16, which halves the
// ldmatrix of A: one A fragment then feeds 4 n8 tiles x 2 output rows).
// Accumulators: 9 taps x WN x 2 n8 tiles x 4 = 72 WN registers, the warp's
// part of dW for the block's life.
template <int WN>
__global__ void __launch_bounds__(THREADS, 1) small_wgrad_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ ws, int h, int w,
    int c, int co, int seg, int segs, int hp, long long units) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NACC = 9 * WN * 2 * 4;
  const int cp = (c + 15) / 16 * 16, cop = (co + 15) / 16 * 16;
  const int ldx = f_ldp(cp), ldg = f_ldp(cop);  // odd multiples of 16 bytes
  const int xppp = cp / 8, gppp = cop / 8;      // 16-byte pieces per staged pixel
  const int x_bytes = (seg + 2) * ldx;
  const int slot_bytes = x_bytes + seg * ldg;
  const uint32_t sbase = xv::mm::smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int no16 = cop / 16, nco = (no16 + WN - 1) / WN;
  const int roles = w_roles(cp, cop, WN);
  const int groups = (THREADS / 32) / roles;
  const int role = warp % roles, grp = warp / roles;
  const int ci = role / nco, cg = role % nco;

  // A = x^T (16 channels x 16 pixels) by ldmatrix.trans of the staged pixel
  // rows: matrices (pixels 0-7 | 8-15) x (channels 0-7 | 8-15), channels
  // fastest; B = g (16 pixels x 8 channels, two n8 tiles per x4): (pixels
  // 0-7 | 8-15) fastest.  A tile past Co reads tile no16 - 1 and is not
  // stored.
  const uint32_t a_off =
      (uint32_t)(((lane & 7) + (lane >> 4) * 8) * ldx + ((lane >> 3) & 1) * 16 + ci * 32);
  uint32_t b_off[WN];
#pragma unroll
  for (int t = 0; t < WN; ++t)
    b_off[t] = (uint32_t)(((lane & 7) + ((lane >> 3) & 1) * 8) * ldg + (lane >> 4) * 16 +
                          min(cg * WN + t, no16 - 1) * 32);

  // acc[tap][t][n8][e]: channel ci*16 + lane/4 + 8(e/2), output channel
  // 16 (cg WN + t) + 8 n8 + 2 (lane%4) + e%2 of tap row dy*3 + dx
  float acc[9][WN][2][4];
#pragma unroll
  for (int tp = 0; tp < 9; ++tp)
#pragma unroll
    for (int t = 0; t < WN; ++t)
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tp][t][n8][e] = 0.f;

  // the copy threads' pieces: piece xpc of pixels xjx, xjx + xstep, ... of
  // each staged x row (gpc, gjx, gstep: g); threads past xstep * xppp copy none
  const int xstep = THREADS / xppp, gstep = THREADS / gppp;
  const int xpc = tid % xppp, xjx = tid < xstep * xppp ? tid / xppp : seg + 2;
  const int gpc = tid % gppp, gjx = tid < gstep * gppp ? tid / gppp : seg;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  for (long long u = units * blockIdx.x / gridDim.x; u < u_end;) {
    const long long band = u / hp;  // (image, segment)
    const int p0 = (int)(u - band * hp);
    const long long band_end = (band + 1) * hp < u_end ? (band + 1) * hp : u_end;
    const int np = (int)(band_end - u);
    const int bi = (int)(band / segs);
    const int x0 = (int)(band - (long long)bi * segs) * seg;
    const size_t img = (size_t)bi * h;

    // ring rows j0 .. j0 + nrows - 1; zeros outside the image and past C, Co
    auto load_rows = [&](int j0, int nrows) {
      for (int j = j0; j < j0 + nrows; ++j) {
        const int y = 2 * p0 - 1 + j;
        const uint32_t sl = sbase + (uint32_t)((j % W_SLOTS) * slot_bytes);
        const bool row_in = y >= 0 && y < h;
        const bf16* xrow = x + (img + (row_in ? y : 0)) * w * c + xpc * 8;
        for (int jx = xjx; jx < seg + 2; jx += xstep) {
          const int xx = x0 + jx - 1;
          const bool in = row_in && xx >= 0 && xx < w && xpc * 8 < c;
          xv::mm::cp_async16(sl + (uint32_t)(jx * ldx + xpc * 16), in ? xrow + xx * c : x, in);
        }
        if (j == 0 || j > 2 * np) continue;  // a halo row: its cotangent is not read
        const bf16* grow = g + (img + (row_in ? y : 0)) * w * co + gpc * 8;
        for (int jx = gjx; jx < seg; jx += gstep) {
          const int xx = x0 + jx;
          const bool in = row_in && xx < w && gpc * 8 < co;
          xv::mm::cp_async16(sl + (uint32_t)(x_bytes + jx * ldg + gpc * 16),
                             in ? grow + xx * co : g, in);
        }
      }
    };
    load_rows(0, 4);  // pass 0
    xv::mm::cp_async_commit();
    if (np > 1) load_rows(4, 2);  // pass 1
    xv::mm::cp_async_commit();

    for (int k = 0; k < np; ++k) {
      xv::mm::cp_async_wait<1>();  // this thread's pieces of pass k's rows have landed
      // every piece has; every warp is done with pass k - 1, whose first two
      // rows' slots the next copies refill
      __syncthreads();
      if (k + 2 < np) load_rows(2 * k + 6, 2);  // pass k + 2's new rows
      xv::mm::cp_async_commit();
      if (grp >= groups) continue;

      uint32_t xs[4], gs[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xs[r] = sbase + (uint32_t)(((2 * k + r) % W_SLOTS) * slot_bytes) + a_off;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        gs[r] = sbase + (uint32_t)(((2 * k + 1 + r) % W_SLOTS) * slot_bytes + x_bytes);
      for (int it = grp; it < seg / 16; it += groups) {
        // B fragments of output rows 2 (p0 + k) + r, pixels 16 it ..
        uint32_t bq[2][WN][2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int t = 0; t < WN; ++t) {
            uint32_t v[4];
            xv::mm::ldmatrix_x4_trans(v, gs[r] + (uint32_t)(it * 16 * ldg) + b_off[t]);
            bq[r][t][0][0] = v[0];
            bq[r][t][0][1] = v[1];
            bq[r][t][1][0] = v[2];
            bq[r][t][1][1] = v[3];
          }
        // input row ir (2 (p0 + k) - 1 + ir) at the tap's pixel offset dx
        // feeds tap row ir of output row 0 and ir - 1 of output row 1
#pragma unroll
        for (int ir = 0; ir < 4; ++ir)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            uint32_t a[4];
            xv::mm::ldmatrix_x4_trans(a, xs[ir] + (uint32_t)((it * 16 + dx) * ldx));
#pragma unroll
            for (int t = 0; t < WN; ++t)
#pragma unroll
              for (int n8 = 0; n8 < 2; ++n8) {
                if (ir < 3) xv::mm::mma_m16n8k16_bf16(acc[ir * 3 + dx][t][n8], a, bq[0][t][n8]);
                if (ir > 0)
                  xv::mm::mma_m16n8k16_bf16(acc[(ir - 1) * 3 + dx][t][n8], a, bq[1][t][n8]);
              }
          }
      }
    }
    xv::mm::cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next band
    u = band_end;
  }

  // the groups' copies of each role, added in group order through the idle
  // ring, then the block's partial dW into its workspace slot
  if (groups > 1) {
    float* red = reinterpret_cast<float*>(smem);
    if (grp >= 1 && grp < groups) {
#pragma unroll
      for (int i = 0; i < NACC; ++i)
        red[(warp * NACC + i) * 32 + lane] = (&acc[0][0][0][0])[i];
    }
    __syncthreads();
    if (grp == 0) {
      for (int gi = 1; gi < groups; ++gi)
#pragma unroll
        for (int i = 0; i < NACC; ++i)
          (&acc[0][0][0][0])[i] += red[((role + gi * roles) * NACC + i) * 32 + lane];
    }
  }
  if (grp != 0) return;
  float* slot = ws + (size_t)blockIdx.x * 9 * c * co;
  const int qd = lane & 3, gr = lane >> 2;
#pragma unroll
  for (int tp = 0; tp < 9; ++tp)
#pragma unroll
    for (int t = 0; t < WN; ++t)
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int ch = ci * 16 + gr + 8 * hf;
          const int tile = cg * WN + t;
          const int o = tile * 16 + n8 * 8 + 2 * qd;
          if (tile < no16 && ch < c && o < co)
            *reinterpret_cast<float2*>(slot + ((size_t)tp * c + ch) * co + o) =
                make_float2(acc[tp][t][n8][2 * hf], acc[tp][t][n8][2 * hf + 1]);
        }
}

// dW = the slots' partials added in a fixed order: a block takes 32
// elements; warp p adds slots p, p + 8, p + 16, ... of its lane's element in
// slot order (32 consecutive floats a load), and thread p = 0 adds the eight
// warps' sums in warp order
constexpr int SUM_PARTS = THREADS / 32;
__global__ void __launch_bounds__(THREADS) small_wgrad_sum_kernel(const float* __restrict__ ws,
                                                                  float* __restrict__ out, int n,
                                                                  int slots) {
  __shared__ float part[SUM_PARTS][32];
  const int lane = threadIdx.x & 31, p = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int k = p; k < slots; k += SUM_PARTS) s += ws[(size_t)k * n + i];
  }
  part[p][lane] = s;
  __syncthreads();
  if (p != 0 || i >= n) return;
  float t = part[0][lane];
#pragma unroll
  for (int q = 1; q < SUM_PARTS; ++q) t += part[q][lane];
  out[i] = t;
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
// f32, written whole.  c and co in 8..64, multiples of 8.  dtype 0 = float32,
// 1 = bfloat16.  bfloat16 needs ws: `slots` x 9c x co f32 of scratch (one
// slot per block, at most `slots` blocks; the caller's SM count fills the
// card); float32 ignores ws and slots.  Returns the cudaError_t of the launch.
extern "C" int small_conv_wgrad(const void* x, const void* g, void* out, void* ws, int b, int h,
                                int w, int c, int co, int dtype, int slots, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 8 || co % 8 || c < 8 || co < 8 || c > 64 || co > 64) return (int)cudaErrorInvalidValue;
  const int n = 9 * c * co;
  if ((long long)b * h * w <= 0) return (int)cudaMemsetAsync(out, 0, (size_t)n * 4, s);
  if (dtype == 1) {
    if (ws == nullptr || slots < 1) return (int)cudaErrorInvalidValue;
    const int cp = (c + 15) / 16 * 16, cop = (co + 15) / 16 * 16;
    const int seg = w_seg(cp, cop, w);
    const int segs = (w + seg - 1) / seg, hp = (h + 1) / 2;
    const long long units = (long long)b * segs * hp;
    const int blocks = units < slots ? (int)units : slots;
    const int wn = cop > 16 ? 2 : 1;
    const size_t ring = (size_t)W_SLOTS * w_slot_bytes(seg, cp, cop);
    const size_t red = (THREADS / 32) / w_roles(cp, cop, wn) > 1
                           ? (size_t)(THREADS / 32) * 9 * wn * 8 * 32 * 4 : 0;
    const size_t smem = ring > red ? ring : red;
    cudaError_t err;
    if (wn == 2) {
      if ((err = allow_smem(small_wgrad_mma_kernel<2>, smem)) != cudaSuccess) return (int)err;
      small_wgrad_mma_kernel<2><<<blocks, THREADS, smem, s>>>(
          (const bf16*)x, (const bf16*)g, (float*)ws, h, w, c, co, seg, segs, hp, units);
    } else {
      if ((err = allow_smem(small_wgrad_mma_kernel<1>, smem)) != cudaSuccess) return (int)err;
      small_wgrad_mma_kernel<1><<<blocks, THREADS, smem, s>>>(
          (const bf16*)x, (const bf16*)g, (float*)ws, h, w, c, co, seg, segs, hp, units);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    small_wgrad_sum_kernel<<<(n + 31) / 32, THREADS, 0, s>>>((const float*)ws, (float*)out, n,
                                                              blocks);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n * 4, s);  // the atomics add into it
    if (err != cudaSuccess) return (int)err;
    const int qn = co / 4;
    int chb = (THREADS / qn) & ~3;  // input channels per block, a multiple of 4
    if (chb > c) chb = c;
    const int tiles_y = (c + chb - 1) / chb;
    const int segs = (w + WF_TM - 1) / WF_TM;
    const size_t smem = align128((size_t)3 * WF_AW * (chb + 1) * 4) + (size_t)WF_TM * co * 4;
    if ((err = allow_smem(small_wgrad_f32_kernel, smem)) != cudaSuccess) return (int)err;
    int per = 0;
    unsigned blocks_x = 0;
    if ((err = split_tasks((long long)b * h * segs, tiles_y, &per, &blocks_x)) != cudaSuccess)
      return (int)err;
    small_wgrad_f32_kernel<<<dim3(blocks_x, (unsigned)tiles_y), THREADS, smem, s>>>(
        (const float*)x, (const float*)g, (float*)out, b, h, w, c, co, chb, segs, per);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
