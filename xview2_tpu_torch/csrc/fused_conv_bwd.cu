// Backward kernels of the fused conv+BN forward (fused_conv.cu).
//
// conv_bn_wgrad replaces the TPU kernel ops/packed_fused_conv.py::
// _wgrad_kernel (_wgrad_impl):
//   dW[(dy, dx, c), o] = sum_{b, y, x} a[b, y+dy-1, x+dx-1, c] * g[b, y, x, o]
// as a (9C, Co) FLOAT32 matrix, where a = prologue(x) inside the image and 0
// in the SAME halo (zeroed after the prologue); the activated map never
// reaches device memory.  The cast to the kernel's dtype is the caller's.
//
// conv_bn_dgrad replaces ops/packed_fused_conv.py::_dgrad_kernel
// (_dgrad_impl):
//   da[b, y, x, c] = sum_{dy, dx, o} g[b, y+dy-1, x+dx-1, o] * kflip[(dy, dx, o), c]
// (g's halo is plain zeros, kflip is the flipped, transposed kernel in g's
// dtype), f32 accumulation, NOT rounded to the storage type; then the
// prologue's gradient inline from the unpadded x:
//   xm = T(x - mean); y = T(T(xm * mul) + bias)      (mean, mul, bias in T)
//   gate = y >= 0 ? 1 : 0.01 (f32);  dy = da * gate
//   dx = T(dy * mul_f32);  dbias[c] += dy;  dmul[c] += dy * float(xm)
// Without a fold the kernel writes dx = T(da) and nothing else.
//
// Bound on the H100: operations for both (2*9*C*Co FLOP per pixel against
// 2*(C + Co) bytes per pixel read, and for dgrad 2*C more of x read and dx
// written, for wgrad a small f32 output): the six layers of a train step do
// 1.24 TFLOP each way, 1.25 ms at the bf16 peak.
//
// Design:
//  * dgrad: three kernels, chosen in the C entry point by the static shape
//    and dtype only (conv_bn_dgrad_variant reports the choice):
//    - bf16 with C % 128 == 0 and Co % 16 == 0 (every layer of the decoder
//      tail: C in {768, 384, 256, 128} from Co in {256, 128}): K2's pipelined
//      wgmma main loop of conv_mma.cuh on (g, kflip), no prologue, with its
//      own epilogue.  Persistent blocks, one per SM, over tiles of R x TW
//      pixels (the least-waste width, as K2) x 128 channels of dx; per chunk
//      of 16 channels of g one halo patch and the nine kflip slabs are staged
//      once into a three-stage cp.async ring.  The epilogue works from the
//      accumulator fragments, four n8 tiles at a time: x is read with 16-byte
//      loads at exactly the pieces the 16-byte dx stores write (asked into L2
//      by the loop's tile-start hook, one chunk into the tile) and brought
//      into the fragment layout by the quad transpose that K2 uses for its
//      stores; the gate, the scale by the unrounded mul and the roundings
//      run on bf16 pairs (bit-equal to the per-element f32 ones, common.cuh);
//      dbias/dmul go by lane shuffles, one shared-memory reduction over the
//      eight warps and one atomicAdd per channel per tile.  dx has no
//      atomics: it is bit-equal from run to run.  The fold vectors of all C
//      channels sit in shared memory (mean, mul, bias in bf16, mul in f32).
//    - bf16 with another C (64, 192): the forward's wmma row tile
//      (conv_tile.cuh, no copy/compute overlap) on g with kflip, the f32
//      result through shared memory into the same arithmetic per element;
//      dbias/dmul are per-thread partials kept across the block's rows, one
//      shared-memory reduction and one atomicAdd per channel per block into
//      zeroed outputs (the TPU kernel's sequential grid added into resident
//      vectors).
//    - f32: the FMA loop of the forward, no TF32.
//    With a fold the epilogue costs a layer 25-50% (the tensor cores wait
//    for it; the x loads are a third to a half of that).  Not done yet for the
//    pipelined kernel: an epilogue that overlaps the next tile's MMAs (two
//    consumer warpgroups taking turns), its tile for C = 64/192 (which would
//    let conv_row_bf16 go), a producer warp, TMA for kflip.
//  * wgrad: the TPU kernel adds into one resident (9C, Co) output across a
//    sequential grid.  Here the reduction dimension, the B*H*W pixels, is
//    SPLIT over blocks that keep an output tile in registers over their pixel
//    range and add it with f32 reductions into the ZEROED output at the end.
//    The order of those additions changes from run to run, so dW is
//    reproducible only to f32 sum-order noise (about 1e-6 of sum |terms|; the
//    callers compare at 1e-3 of max |dW|).  Two bf16 kernels and one f32
//    kernel, chosen in the C entry point by the static shape and dtype only
//    (conv_bn_wgrad_variant reports the choice):
//    - bf16 with C % 64 == 0 (every layer of the decoder tail): the
//      pipelined wgmma kernel below.  A block of 384 threads owns the output
//      tile 9 taps x 64 input channels x 64 output channels and a strip of 64
//      image columns over a range of rows.  The tile is as large as the
//      registers allow: 9 x 64 x 128 f32 accumulators would be 73,728
//      registers, more than the 65,536 of an SM, so the output channels stay
//      at 64 (x is read Co/64 times, g C/64 times, from L2 after the first).
//      The taps are split over the three warpgroups, one dy each with its
//      three dx accumulators of 64 x 64 (96 registers a thread).  Moving down
//      one image row brings in ONE new row of x (66 pixels with the column
//      halo) and one of g by cp.async (zero fill outside the image) into a
//      six-slot ring, three rows ahead of the MMAs: each row is staged once
//      per block and serves dy = 0, 1, 2 of three output rows.  With a fold
//      each thread applies the prologue in place to the pieces of x it copied
//      itself, once per element, one row ahead and behind queued MMAs.
//      Pixels are the reduction dimension.  The shifted operand, x, goes
//      through registers: ldmatrix.trans reads the A^T fragment from the
//      channel-contiguous pixel rows, and a tap's dx is a one-pixel pointer
//      offset.  The unshifted operand, g, lies in shared memory in the
//      128-byte-swizzled N-contiguous layout and is read by
//      wgmma.m64n64k16 itself (its transposed-B form); one g slab serves
//      the three dx.  One barrier per image row.  The row ranges are cut so
//      that at least two blocks per SM exist; the tile leaves with one
//      red.global.add.v2.f32 per pair.
//    - bf16 with another C (32): nine 16x16 wmma accumulators per warp over
//      a (32 x 64) tile, operands staged through registers, no overlap.
//    - f32: 9 x 4 FMA accumulators per thread, no TF32.

#include "conv_mma.cuh"
#include "conv_tile.cuh"

namespace {

using namespace xv;

// ------------------------------------------------------------------- wgrad
constexpr int WG_TM = 64;           // pixels per staged segment
constexpr int WG_AW = WG_TM + 2;    // staged input columns (with halo)
constexpr int LDG_H = TN + 8;       // staged g row stride, bf16
constexpr size_t WG_A_BYTES_H = align128(3ull * WG_AW * LDA_H * 2);
constexpr size_t WG_G_BYTES_H = align128((size_t)WG_TM * LDG_H * 2);
constexpr size_t WG_P_BYTES_H = 8ull * 256 * 4;  // one 16x16 f32 patch per warp
constexpr size_t WG_A_BYTES_F = align128(3ull * WG_AW * LDA_F * 4);
constexpr size_t WG_G_BYTES_F = (size_t)WG_TM * TN * 4;

// Stage g[b, y, x0 .. x0+WG_TM-1, n0 .. n0+TN-1] as Gs[p*LD + n]; zero beyond w.
template <typename T, int LD>
__device__ __forceinline__ void stage_g(T* __restrict__ Gs, const T* __restrict__ g, int b, int y,
                                        int x0, int n0, int h, int w, int co) {
  constexpr int V = 16 / (int)sizeof(T);
  for (int v = threadIdx.x; v < WG_TM * (TN / V); v += THREADS) {
    const int nv = v % (TN / V);
    const int p = v / (TN / V);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (x0 + p < w)
      val = *reinterpret_cast<const uint4*>(g + (((size_t)b * h + y) * w + x0 + p) * co + n0 +
                                            nv * V);
    *reinterpret_cast<uint4*>(Gs + p * LD + nv * V) = val;
  }
}

template <bool FOLD>
__global__ void __launch_bounds__(THREADS) wgrad_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ fold, float* __restrict__ out, int bsz, int h, int w, int c, int co,
    int segs, int tasks_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(smem + WG_A_BYTES_H);
  float* patch = reinterpret_cast<float*>(smem + WG_A_BYTES_H + WG_G_BYTES_H);
  float* fs = reinterpret_cast<float*>(smem + WG_A_BYTES_H + WG_G_BYTES_H + WG_P_BYTES_H);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c_tiles = c / KC_H;
  const int c0 = (blockIdx.y % c_tiles) * KC_H;
  const int co0 = (blockIdx.y / c_tiles) * TN;
  const int ci = warp / 4;   // which 16 input channels of the chunk
  const int coj = warp % 4;  // which 16 output channels of the tile
  const float slope = rnd<__nv_bfloat16>(kLeakySlope);
  if (FOLD) {
    for (int i = tid; i < 3 * c; i += THREADS) fs[i] = rnd<__nv_bfloat16>(fold[i]);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wmma::fill_fragment(acc[t], 0.f);

  const int total = bsz * h * segs;
  const int first = blockIdx.x * tasks_per_block;
  const int last = min(first + tasks_per_block, total);
  for (int task = first; task < last; ++task) {
    const int b = task / (h * segs);
    const int rem = task - b * h * segs;
    const int y = rem / segs;
    const int x0 = (rem - y * segs) * WG_TM;
    __syncthreads();  // the previous segment's reads are done
    stage_rows<__nv_bfloat16, FOLD, KC_H, LDA_H>(As, x, fs, b, y, x0, c0, h, w, c, WG_AW, slope);
    stage_g<__nv_bfloat16, LDG_H>(Gs, g, b, y, x0, co0, h, w, co);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WG_TM / 16; ++ks) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> gf;
      wmma::load_matrix_sync(gf, Gs + (ks * 16) * LDG_H + coj * 16, LDG_H);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // A^T: element (channel i, pixel k) at As[(row + k) * LDA_H + i]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af;
          wmma::load_matrix_sync(af, As + (dy * WG_AW + ks * 16 + dx) * LDA_H + ci * 16, LDA_H);
          wmma::mma_sync(acc[dy * 3 + dx], af, gf, acc[dy * 3 + dx]);
        }
      }
    }
  }

  float* mine = patch + warp * 256;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    wmma::store_matrix_sync(mine, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    float* dst = out + ((size_t)t * c + c0 + ci * 16) * co + co0 + coj * 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = lane + 32 * i;
      atomicAdd(dst + (size_t)(idx / 16) * co + idx % 16, mine[idx]);
    }
    __syncwarp();
  }
}

template <bool FOLD>
__global__ void __launch_bounds__(THREADS) wgrad_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ fold,
    float* __restrict__ out, int bsz, int h, int w, int c, int co, int segs,
    int tasks_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Gs = reinterpret_cast<float*>(smem + WG_A_BYTES_F);
  float* fs = reinterpret_cast<float*>(smem + WG_A_BYTES_F + WG_G_BYTES_F);

  const int tid = threadIdx.x;
  const int ch = tid / 16;  // input channel of the chunk
  const int q = tid % 16;   // output channels q*4 .. q*4+3
  const int c_tiles = c / KC_F;
  const int c0 = (blockIdx.y % c_tiles) * KC_F;
  const int co0 = (blockIdx.y / c_tiles) * TN;
  if (FOLD) {
    for (int i = tid; i < 3 * c; i += THREADS) fs[i] = fold[i];
  }
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
    const int x0 = (rem - y * segs) * WG_TM;
    __syncthreads();
    stage_rows<float, FOLD, KC_F, LDA_F>(As, x, fs, b, y, x0, c0, h, w, c, WG_AW, kLeakySlope);
    stage_g<float, TN>(Gs, g, b, y, x0, co0, h, w, co);
    __syncthreads();
    for (int p = 0; p < WG_TM; ++p) {
      const float4 gv = *reinterpret_cast<const float4*>(Gs + p * TN + q * 4);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float a = As[(dy * WG_AW + p + dx) * LDA_F + ch];
          const int t = dy * 3 + dx;
          acc[t][0] = fmaf(a, gv.x, acc[t][0]);
          acc[t][1] = fmaf(a, gv.y, acc[t][1]);
          acc[t][2] = fmaf(a, gv.z, acc[t][2]);
          acc[t][3] = fmaf(a, gv.w, acc[t][3]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    float* dst = out + ((size_t)t * c + c0 + ch) * co + co0 + q * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(dst + j, acc[t][j]);
  }
}

// ------------------------------------------------- wgrad, pipelined bf16
constexpr int WP_THREADS = 384;                // three warpgroups, one dy each
constexpr int WP_TC = 64;                      // input channels of the tile
constexpr int WP_TO = 64;                      // output channels of the tile
constexpr int WP_PX = 64;                      // image columns of a block's strip
constexpr int WP_LD = 64 + 8;                  // 72 halves = 144 bytes per staged pixel of x
constexpr int WP_AHEAD = 3;                    // rows in flight ahead of the MMAs
constexpr int WP_SLOTS = WP_AHEAD + 3;         // rows y-1, y, y+1 stay resident
constexpr int WP_G_BYTES = WP_PX * 128;        // g row: 64 pixels x 128 bytes, swizzled
constexpr int WP_X_BYTES = mm::align1024i((WP_PX + 2) * WP_LD * 2);
constexpr int WP_STAGE = WP_G_BYTES + WP_X_BYTES;  // g first: it must be 1024-byte aligned
constexpr int WP_SMEM = WP_SLOTS * WP_STAGE + 1024;
constexpr int WP_X_VEC = (WP_PX + 2) * 8;      // 16-byte pieces of a staged x row
constexpr int WP_VEC = WP_X_VEC + WP_PX * 8;   // ... and of the g row
constexpr int WP_IT = (WP_VEC + WP_THREADS - 1) / WP_THREADS;

// Block (blockIdx.x) = (output tile, image, column strip, row range).  Stage
// s of a block holds x row ya - 1 + s and g row ya + s - 2, so that when stage
// s has landed, output row y = ya + s - 2 has its three x rows (stages s - 2,
// s - 1, s) and its g row.
template <bool FOLD>
__global__ void __launch_bounds__(WP_THREADS, 1) wgrad_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ fold, float* __restrict__ out, int h, int w, int c, int co,
    int strips, int row_splits, int rows_per, int c_tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* fs = reinterpret_cast<__nv_bfloat16*>(smem_raw + WP_SMEM);  // (3, 64) fold
  const uint32_t sraw = mm::smem_u32(smem_raw);
  const uint32_t sbase = (sraw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (sbase - sraw);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int dy = warp >> 2;  // this warpgroup's row of taps
  const int wq = warp & 3;   // this warp's 16 input channels of the tile's 64
  int idx = blockIdx.x;
  const int rs = idx % row_splits;
  idx /= row_splits;
  const int x0 = (idx % strips) * WP_PX;
  idx /= strips;
  const int c0 = (idx % c_tiles) * WP_TC;
  idx /= c_tiles;
  const int co_tiles = co / WP_TO;
  const int co0 = (idx % co_tiles) * WP_TO;
  const int b = idx / co_tiles;
  const int ya = rs * rows_per, yb = min(ya + rows_per, h);
  const int n_stage = yb - ya + 2;
  const __nv_bfloat162 slope = __float2bfloat162_rn(kLeakySlope);
  if (FOLD) {
    for (int i = tid; i < 3 * WP_TC; i += WP_THREADS)
      fs[i] = __float2bfloat16(fold[(i / WP_TC) * c + c0 + i % WP_TC]);
    __syncthreads();
  }

  // this thread's pieces of a stage: x pieces first, then g pieces
  const __nv_bfloat16* src[WP_IT];  // row 0 of image b at this piece's column and channels
  uint32_t dst[WP_IT];
  bool is_x[WP_IT], col_in[WP_IT];
#pragma unroll
  for (int i = 0; i < WP_IT; ++i) {
    const int v = tid + i * WP_THREADS;
    is_x[i] = v < WP_X_VEC;
    const int u = is_x[i] ? v : v - WP_X_VEC;
    const int pix = u >> 3, cv = u & 7;
    const int xx = is_x[i] ? x0 + pix - 1 : x0 + pix;
    col_in[i] = v < WP_VEC && xx >= 0 && xx < w;
    const size_t img = (size_t)b * h * w;
    src[i] = !col_in[i] ? x
             : is_x[i]  ? x + (img + xx) * c + c0 + cv * 8
                        : g + (img + xx) * co + co0 + cv * 8;
    dst[i] = is_x[i] ? (uint32_t)(WP_G_BYTES + (pix * WP_LD + cv * 8) * 2)
                     : (uint32_t)((pix >> 4) * 2048) + mm::swizzled_piece(pix & 15, cv);
  }

  auto load_stage = [&](int s) {
    const uint32_t st = sbase + (uint32_t)((s % WP_SLOTS) * WP_STAGE);
    const int yx = ya - 1 + s, yg = ya + s - 2;
    const bool x_row = yx >= 0 && yx < h;
#pragma unroll
    for (int i = 0; i < WP_IT; ++i) {
      if (tid + i * WP_THREADS >= WP_VEC) continue;
      if (is_x[i]) {
        const bool in = x_row && col_in[i];
        mm::cp_async16(st + dst[i], in ? src[i] + (size_t)yx * w * c : x, in);
      } else if (s >= 2) {
        mm::cp_async16(st + dst[i], col_in[i] ? src[i] + (size_t)yg * w * co : g, col_in[i]);
      }
    }
  };
  auto fold_own = [&](int s) {  // this thread's pieces of stage s, landed
    const int yx = ya - 1 + s;
    if (FOLD && yx >= 0 && yx < h) {
      // 384 % 8 == 0: all of a thread's pieces cover the same 8 channels
      const __nv_bfloat16* f = fs + (tid & 7) * 8;
      const uint4 mean = *reinterpret_cast<const uint4*>(f);
      const uint4 mul = *reinterpret_cast<const uint4*>(f + WP_TC);
      const uint4 bias = *reinterpret_cast<const uint4*>(f + 2 * WP_TC);
#pragma unroll
      for (int i = 0; i < WP_IT; ++i)
        if (is_x[i] && col_in[i])
          mm::prologue_piece(smem + (s % WP_SLOTS) * WP_STAGE + dst[i], mean, mul, bias, slope);
    }
    mm::fence_async_shared();  // the g pieces this thread copied, before wgmma reads them
  };

  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;

  // A^T (this warp's 16 channels x 16 pixels) is read with ldmatrix.trans from
  // the pixel rows of x: matrix lane/8 covers pixels (lane/16)*8.. and channels
  // ((lane/8)%2)*8..
  const uint32_t a_off = (uint32_t)(
      WP_G_BYTES + (((lane & 7) + (lane >> 4) * 8) * WP_LD + wq * 16 + ((lane >> 3) & 1) * 8) * 2);

#pragma unroll
  for (int s = 0; s < WP_AHEAD; ++s) {
    if (s < n_stage) load_stage(s);
    mm::cp_async_commit();
  }
  mm::cp_async_wait<WP_AHEAD - 1>();
  fold_own(0);
  for (int s = 0; s < n_stage; ++s) {
    // stage s is whole.  Every warp past this barrier has waited for all its
    // MMAs of output row s - 2 (at most one step stays in flight), so the slot
    // of stage s - 3 is free and the tensor cores never drain before a barrier
    __syncthreads();
    if (s + WP_AHEAD < n_stage) load_stage(s + WP_AHEAD);  // into the slot of stage s - 3
    mm::cp_async_commit();
    if (s >= 2) {
      const uint32_t xs = sbase + (uint32_t)(((s - 2 + dy) % WP_SLOTS) * WP_STAGE) + a_off;
      const uint32_t gs = sbase + (uint32_t)((s % WP_SLOTS) * WP_STAGE);
      uint32_t a[2][3][4];
#pragma unroll
      for (int ks = 0; ks < WP_PX / 16; ++ks) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          mm::ldmatrix_x4_trans(a[ks & 1][dx], xs + (uint32_t)((ks * 16 + dx) * WP_LD * 2));
        const uint64_t desc = mm::wgmma_desc_b(gs + (uint32_t)(ks * 2048), 0);
        mm::wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) mm::wgmma_m64n64k16(acc[dx], a[ks & 1][dx], desc, 1);
        mm::wgmma_commit();
        if (ks == 1) {  // stage s + 1 has landed: prologue on it behind queued MMAs
          mm::cp_async_wait<WP_AHEAD - 1>();
          if (s + 1 < n_stage) fold_own(s + 1);
        }
        mm::wgmma_wait<1>();  // step ks - 1 is done: its A registers are free
      }
    } else {
      mm::cp_async_wait<WP_AHEAD - 1>();
      fold_own(s + 1);
    }
  }
  mm::cp_async_wait<0>();
  mm::wgmma_wait<0>();

  // this lane holds channels 16*wq + gq and + 8, output channels j*8 + q*2, +1
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = out + ((size_t)(dy * 3 + dx) * c + c0 + wq * 16 + gq + hh * 8) * co + co0 + q * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mm::red_add_f32x2(row + j * 8, acc[dx][4 * j + hh * 2], acc[dx][4 * j + hh * 2 + 1]);
    }
}

template <bool FOLD>
cudaError_t launch_wgrad_wgmma(const void* x, const void* g, const float* fold, float* out, int b,
                             int h, int w, int c, int co, cudaStream_t stream) {
  const size_t smem = (size_t)WP_SMEM + 3ull * WP_TC * 2;
  cudaError_t err = cudaFuncSetAttribute(wgrad_wgmma_kernel<FOLD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int strips = (w + WP_PX - 1) / WP_PX;
  const int c_tiles = c / WP_TC;
  const long long units = (long long)b * strips * c_tiles * (co / WP_TO);
  if (units <= 0 || h <= 0) return cudaGetLastError();
  // at least two blocks per SM, but no range shorter than 8 rows (each range
  // reads two rows of x beyond its own)
  long long want = (2LL * sms + units - 1) / units;
  const int most = (h + 7) / 8;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const int rows_per = (int)((h + want - 1) / want);
  const int row_splits = (h + rows_per - 1) / rows_per;
  const long long blocks = units * row_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wgrad_wgmma_kernel<FOLD><<<(unsigned)blocks, WP_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, fold, out, h, w, c, co, strips, row_splits,
      rows_per, c_tiles);
  return cudaGetLastError();
}

template <typename T, typename K>
cudaError_t launch_wgrad(K kern, size_t smem, int kc, const void* x, const void* g,
                         const float* fold, float* out, int b, int h, int w, int c, int co,
                         cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int segs = (w + WG_TM - 1) / WG_TM;
  const long long total = (long long)b * h * segs;
  const int tiles = (c / kc) * (co / TN);
  if (total <= 0 || tiles <= 0) return cudaGetLastError();
  // about four blocks per SM in all, each with a contiguous range of segments
  long long splits = (4LL * sms + tiles - 1) / tiles;
  if (splits < 1) splits = 1;
  if (splits > total) splits = total;
  const int per = (int)((total + splits - 1) / splits);
  const dim3 grid((unsigned)((total + per - 1) / per), (unsigned)tiles);
  kern<<<grid, THREADS, smem, stream>>>((const T*)x, (const T*)g, fold, out, b, h, w, c, co, segs,
                                        per);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- dgrad
// g: (b, h, w, co); kflip: (9co, c); x/dx: (b, h, w, c); fold: (3, c) f32.
template <bool FOLD>
__global__ void __launch_bounds__(THREADS) dgrad_bf16_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ kflip,
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ fold,
    __nv_bfloat16* __restrict__ dx, float* __restrict__ dbias, float* __restrict__ dmul, int h,
    int w, int co, int c, int row_groups, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);       // the row's da tile
  float* red = reinterpret_cast<float*>(smem + STAGE_BYTES_H);  // (2, 4, TN) partial sums

  const int tid = threadIdx.x;
  const int b = blockIdx.x / row_groups;
  const int y0 = (blockIdx.x - b * row_groups) * ROWS;
  const int x0 = (blockIdx.y % col_tiles) * TM;
  const int c0 = (blockIdx.y / col_tiles) * TN;
  const int en = tid % TN;  // this thread's channel; pixels r = tid/TN + 4*i
  float mean = 0.f, mul = 0.f, bias = 0.f, mul_raw = 0.f;
  if (FOLD) {
    mean = rnd<__nv_bfloat16>(fold[c0 + en]);
    mul_raw = fold[c + c0 + en];
    mul = rnd<__nv_bfloat16>(mul_raw);
    bias = rnd<__nv_bfloat16>(fold[2 * c + c0 + en]);
  }
  float p1 = 0.f, p2 = 0.f;

  for (int y = y0; y < min(y0 + ROWS, h); ++y) {
    conv_row_bf16<false>(smem, g, kflip, nullptr, b, y, x0, c0, h, w, co, c, 0.f);
    for (int r = tid / TN; r < TM; r += THREADS / TN) {
      if (x0 + r < w) {
        const float da = Cs[r * LDC_H + en];
        const size_t idx = (((size_t)b * h + y) * w + x0 + r) * c + c0 + en;
        if (FOLD) {
          const float xm = rnd<__nv_bfloat16>(__fsub_rn(__bfloat162float(x[idx]), mean));
          const float yv =
              rnd<__nv_bfloat16>(__fadd_rn(rnd<__nv_bfloat16>(__fmul_rn(xm, mul)), bias));
          const float dyv = __fmul_rn(da, yv >= 0.f ? 1.f : kLeakySlope);
          dx[idx] = __float2bfloat16(__fmul_rn(dyv, mul_raw));
          p1 += dyv;
          p2 = fmaf(dyv, xm, p2);
        } else {
          dx[idx] = __float2bfloat16(da);
        }
      }
    }
  }
  if (FOLD) reduce_sums_bf16(red, p1, p2, dbias + c0, dmul + c0);
}

template <bool FOLD>
__global__ void __launch_bounds__(THREADS) dgrad_f32_kernel(
    const float* __restrict__ g, const float* __restrict__ kflip, const float* __restrict__ x,
    const float* __restrict__ fold, float* __restrict__ dx, float* __restrict__ dbias,
    float* __restrict__ dmul, int h, int w, int co, int c, int row_groups, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + STAGE_BYTES_F);  // (2, 16, TN)

  const int tid = threadIdx.x;
  const int tn = tid % 16;  // channels tn*4 .. tn*4+3
  const int tm = tid / 16;  // pixels tm*8 .. tm*8+7
  const int b = blockIdx.x / row_groups;
  const int y0 = (blockIdx.x - b * row_groups) * ROWS;
  const int x0 = (blockIdx.y % col_tiles) * TM;
  const int c0 = (blockIdx.y / col_tiles) * TN;
  float mean[4] = {0.f, 0.f, 0.f, 0.f}, mul[4] = {0.f, 0.f, 0.f, 0.f};
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (FOLD) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mean[j] = fold[c0 + tn * 4 + j];
      mul[j] = fold[c + c0 + tn * 4 + j];
      bias[j] = fold[2 * c + c0 + tn * 4 + j];
    }
  }
  float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};

  for (int y = y0; y < min(y0 + ROWS, h); ++y) {
    float acc[8][4];
    conv_row_f32<false>(smem, acc, g, kflip, nullptr, b, y, x0, c0, h, w, co, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int xp = x0 + tm * 8 + i;
      if (xp < w) {
        const size_t idx = (((size_t)b * h + y) * w + xp) * c + c0 + tn * 4;
        float o[4];
        if (FOLD) {
          const float4 xv4 = *reinterpret_cast<const float4*>(x + idx);
          const float xv[4] = {xv4.x, xv4.y, xv4.z, xv4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xm = __fsub_rn(xv[j], mean[j]);
            const float yv = __fadd_rn(__fmul_rn(xm, mul[j]), bias[j]);
            const float dyv = __fmul_rn(acc[i][j], yv >= 0.f ? 1.f : kLeakySlope);
            o[j] = __fmul_rn(dyv, mul[j]);
            p1[j] += dyv;
            p2[j] = fmaf(dyv, xm, p2[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = acc[i][j];
        }
        *reinterpret_cast<float4*>(dx + idx) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  if (FOLD) reduce_sums_f32(red, p1, p2, dbias + c0, dmul + c0);
}

// The pipelined bf16 input gradient: conv_mma.cuh's persistent main loop on
// (g, kflip) without a prologue (cin = Co, cout = C), and this epilogue on its
// accumulators.  Shared memory behind the ring: the (2, 8, 128) partial sums,
// then, with a fold, mul in f32 (c) and mean, mul, bias rounded to bf16 (3, c).
template <int TW, bool FOLD>
__global__ void __launch_bounds__(mm::THREADS, 1) dgrad_wgmma_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ kflip,
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ fold,
    __nv_bfloat16* __restrict__ dx, float* __restrict__ dbias, float* __restrict__ dmul,
    const mm::ConvGeom gm) {
  using T = mm::Tile<TW>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + T::SMEM);  // (2, 8, 128) partial sums
  float* fmul = red + 2 * 8 * mm::TNB;                    // (c) mul, unrounded
  __nv_bfloat16* fs = reinterpret_cast<__nv_bfloat16*>(fmul + gm.cout);  // (3, c) rounded

  const int c = gm.cout;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (FOLD) {
    for (int i = tid; i < c; i += mm::THREADS) fmul[i] = fold[c + i];
    for (int i = tid; i < 3 * c; i += mm::THREADS) fs[i] = __float2bfloat16(fold[i]);
    __syncthreads();
  }

  // Offsets of this lane's four rows: g and g + 8 of its warp's 16 in both m64
  // blocks (r = 2*mb + hh), as element offsets into x and dx of the 16-byte
  // piece at channel n0 + 8q, or -1 outside the image.
  auto row_offsets = [&](long long (&off)[4], int b, int y0, int x0, int n0) {
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = (warp >> 2) * 128 + (r >> 1) * 64 + (warp & 3) * 16 + gq + (r & 1) * 8;
      const int y = y0 + p / TW, xx = x0 + p % TW;
      off[r] = (y < gm.h && xx < gm.w) ? (((long long)b * gm.h + y) * gm.w + xx) * c + n0 + q * 8
                                       : -1;
    }
  };
  // With a fold, x of the tile's pixels is asked into L2 as soon as the tile
  // has started, so that the epilogue's loads do not wait on device memory:
  // lanes 0 and 1 of a quad each take one 128-byte line of a row's 128 channels.
  auto prefetch_x = [&](int b, int y0, int x0, int n0) {
    long long off[4];
    row_offsets(off, b, y0, x0, n0);
    if ((lane & 3) < 2)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (off[r] >= 0) mm::prefetch_l2(x + off[r] - (lane & 3) * 8 + (lane & 3) * 64);
  };

  // K2's fragment walk, four n8 tiles at a time: this lane holds rows g and
  // g + 8 of its warp's 16 in both m64 blocks, channels 8j + 2q, +1 of tile j.
  // x is read at the 16-byte pieces the dx stores will write (lane q: the
  // eight channels of tile 4*jj + q), all four rows' loads issued together,
  // and brought into the fragment layout by the quad transpose; dx pairs go
  // back the same way.  The fold of a channel pair is read once for the four
  // rows.
  auto epilogue = [&](const float (&acc)[2][64], int b, int y0, int x0, int n0) {
    const int gq = lane >> 2, q = lane & 3;
    long long off[4];
    row_offsets(off, b, y0, x0, n0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t xv[4][4];  // [row][k]: after the transpose, the row's pair of tile 4*jj + k
      if (FOLD) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (off[r] >= 0) v = *reinterpret_cast<const uint4*>(x + off[r] + jj * 32);
          xv[r][0] = v.x, xv[r][1] = v.y, xv[r][2] = v.z, xv[r][3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) mm::quad_transpose(xv[r], q);
      }
      float p1[4][2], p2[4][2];
      uint32_t v[4][4];  // [row][k]: dx pairs
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jj + k;
        __nv_bfloat162 mean = {}, mul = {}, bias = {};
        float2 mraw = {};
        if (FOLD) {
          const int ch = n0 + 8 * j + 2 * q;
          mean = *reinterpret_cast<const __nv_bfloat162*>(fs + ch);
          mul = *reinterpret_cast<const __nv_bfloat162*>(fs + c + ch);
          bias = *reinterpret_cast<const __nv_bfloat162*>(fs + 2 * c + ch);
          mraw = *reinterpret_cast<const float2*>(fmul + ch);
        }
        p1[k][0] = p1[k][1] = p2[k][0] = p2[k][1] = 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float d0 = acc[r >> 1][4 * j + (r & 1) * 2];
          const float d1 = acc[r >> 1][4 * j + (r & 1) * 2 + 1];
          __nv_bfloat162 res;
          if (FOLD) {
            const __nv_bfloat162 xm =
                __hsub2_rn(*reinterpret_cast<const __nv_bfloat162*>(&xv[r][k]), mean);
            const float2 yv = __bfloat1622float2(__hadd2_rn(__hmul2_rn(xm, mul), bias));
            const float dy0 = yv.x >= 0.f ? d0 : __fmul_rn(d0, kLeakySlope);
            const float dy1 = yv.y >= 0.f ? d1 : __fmul_rn(d1, kLeakySlope);
            res = __floats2bfloat162_rn(__fmul_rn(dy0, mraw.x), __fmul_rn(dy1, mraw.y));
            if (off[r] >= 0) {
              const float2 xmf = __bfloat1622float2(xm);
              p1[k][0] += dy0;
              p1[k][1] += dy1;
              p2[k][0] = fmaf(dy0, xmf.x, p2[k][0]);
              p2[k][1] = fmaf(dy1, xmf.y, p2[k][1]);
            }
          } else {
            res = __floats2bfloat162_rn(d0, d1);
          }
          v[r][k] = *reinterpret_cast<const uint32_t*>(&res);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mm::quad_transpose(v[r], q);
        if (off[r] >= 0)
          *reinterpret_cast<uint4*>(dx + off[r] + jj * 32) =
              make_uint4(v[r][0], v[r][1], v[r][2], v[r][3]);
      }
      if (FOLD) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              p1[k][e] += __shfl_xor_sync(0xffffffffu, p1[k][e], m);
              p2[k][e] += __shfl_xor_sync(0xffffffffu, p2[k][e], m);
            }
            if (gq == 0) {
              red[warp * mm::TNB + (4 * jj + k) * 8 + q * 2 + e] = p1[k][e];
              red[(8 + warp) * mm::TNB + (4 * jj + k) * 8 + q * 2 + e] = p2[k][e];
            }
          }
      }
    }
    if (FOLD) {
      __syncthreads();
      const int n = tid & (mm::TNB - 1), which = tid / mm::TNB;  // 0: dbias, 1: dmul
      const float* r = red + which * 8 * mm::TNB + n;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += r[k * mm::TNB];
      atomicAdd((which ? dmul : dbias) + n0 + n, s);
    }
  };
  if constexpr (FOLD)
    mm::conv_tiles_wgmma<TW, false>(smem, g, kflip, nullptr, gm, epilogue, prefetch_x);
  else
    mm::conv_tiles_wgmma<TW, false>(smem, g, kflip, nullptr, gm, epilogue);
}

template <int TW>
cudaError_t launch_dgrad_wgmma(const void* g, const void* kflip, const void* x, const float* fold,
                               void* dx, float* dbias, float* dmul, int b, int h, int w, int co,
                               int c, cudaStream_t stream) {
  const size_t smem = (size_t)mm::Tile<TW>::SMEM + 2ull * 8 * mm::TNB * 4 + c * 4ull + 3ull * c * 2;
  auto kern = fold ? dgrad_wgmma_kernel<TW, true> : dgrad_wgmma_kernel<TW, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mm::ConvGeom gm;
  unsigned blocks = 0;
  if ((err = mm::conv_launch_shape<TW>(b, h, w, co, c, gm, blocks)) != cudaSuccess) return err;
  if (blocks > 0)
    kern<<<blocks, mm::THREADS, smem, stream>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)kflip, (const __nv_bfloat16*)x, fold,
        (__nv_bfloat16*)dx, dbias, dmul, gm);
  return cudaGetLastError();
}

template <typename T, typename K>
cudaError_t launch_dgrad(K kern, size_t smem, const void* g, const void* kflip, const void* x,
                         const float* fold, void* dx, float* dbias, float* dmul, int b, int h,
                         int w, int co, int c, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int row_groups = (h + ROWS - 1) / ROWS;
  const int col_tiles = (w + TM - 1) / TM;
  const dim3 grid((unsigned)(b * row_groups), (unsigned)(col_tiles * (c / TN)));
  if (grid.x > 0 && grid.y > 0)
    kern<<<grid, THREADS, smem, stream>>>((const T*)g, (const T*)kflip, (const T*)x, fold, (T*)dx,
                                          dbias, dmul, h, w, co, c, row_groups, col_tiles);
  return cudaGetLastError();
}

}  // namespace

// x: (b, h, w, c) and g: (b, h, w, co), contiguous, same dtype; fold: (3, c)
// f32 = mean, mul, bias, or NULL for no prologue; out: (9c, co) f32, ZEROED
// by the caller.  dtype 0 = float32 (c % 16 == 0), 1 = bfloat16 (c % 32 ==
// 0); co % 64 == 0 for both.  Returns the cudaError_t of the launch.
extern "C" int conv_bn_wgrad(const void* x, const void* g, const void* fold, void* out, int b,
                             int h, int w, int c, int co, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)fold;
  float* o = (float*)out;
  if (co % TN) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (c % KC_H) return (int)cudaErrorInvalidValue;
    if (c % WP_TC == 0) {
      if (f) return (int)launch_wgrad_wgmma<true>(x, g, f, o, b, h, w, c, co, s);
      return (int)launch_wgrad_wgmma<false>(x, g, f, o, b, h, w, c, co, s);
    }
    const size_t smem = WG_A_BYTES_H + WG_G_BYTES_H + WG_P_BYTES_H + 3ull * c * 4;
    if (f)
      return (int)launch_wgrad<__nv_bfloat16>(wgrad_bf16_kernel<true>, smem, KC_H, x, g, f, o, b,
                                              h, w, c, co, s);
    return (int)launch_wgrad<__nv_bfloat16>(wgrad_bf16_kernel<false>, smem, KC_H, x, g, f, o, b, h,
                                            w, c, co, s);
  }
  if (dtype == 0) {
    if (c % KC_F) return (int)cudaErrorInvalidValue;
    const size_t smem = WG_A_BYTES_F + WG_G_BYTES_F + 3ull * c * 4;
    if (f)
      return (int)launch_wgrad<float>(wgrad_f32_kernel<true>, smem, KC_F, x, g, f, o, b, h, w, c,
                                      co, s);
    return (int)launch_wgrad<float>(wgrad_f32_kernel<false>, smem, KC_F, x, g, f, o, b, h, w, c,
                                    co, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Which kernel conv_bn_wgrad launches for this static shape and dtype: 0 =
// the f32 FMA kernel, 1 = the bf16 wmma tile (9 taps x 32 x 64), 2 = the
// pipelined wgmma kernel (9 taps x 64 x 64, 64-column strips); -1 = not
// taken.
extern "C" int conv_bn_wgrad_variant(int h, int w, int c, int co, int dtype) {
  if (co % TN) return -1;
  if (dtype == 0) return c % KC_F ? -1 : 0;
  if (dtype != 1 || c % KC_H) return -1;
  return c % WP_TC == 0 ? 2 : 1;
}

// g: (b, h, w, co) contiguous; kflip: (9co, c) contiguous, same dtype as g;
// x: (b, h, w, c) the forward's raw input (read only with a fold); fold: (3,
// c) f32 or NULL; dx: (b, h, w, c); dbias, dmul: (c,) f32, ZEROED by the
// caller and untouched without a fold.  dtype 0 = float32 (co % 16 == 0), 1 =
// bfloat16 (co % 16 == 0 with c % 128 == 0, else co % 32 == 0); c % 64 == 0
// for both.  Returns the cudaError_t of the launch.
extern "C" int conv_bn_dgrad(const void* g, const void* kflip, const void* x, const void* fold,
                             void* dx, void* dbias, void* dmul, int b, int h, int w, int co,
                             int c, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)fold;
  float* db = (float*)dbias;
  float* dm = (float*)dmul;
  if (c % TN) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (c % mm::TNB == 0 && co % mm::KC == 0) {
      const int tw = mm::pick_tile_width(h, w);
      auto* launch = tw == 128 ? &launch_dgrad_wgmma<128>
                     : tw == 64 ? &launch_dgrad_wgmma<64>
                     : tw == 32 ? &launch_dgrad_wgmma<32>
                                : &launch_dgrad_wgmma<16>;
      return (int)launch(g, kflip, x, f, dx, db, dm, b, h, w, co, c, s);
    }
    if (co % KC_H) return (int)cudaErrorInvalidValue;
    const size_t smem = STAGE_BYTES_H + RED_BYTES_H;
    if (f)
      return (int)launch_dgrad<__nv_bfloat16>(dgrad_bf16_kernel<true>, smem, g, kflip, x, f, dx,
                                              db, dm, b, h, w, co, c, s);
    return (int)launch_dgrad<__nv_bfloat16>(dgrad_bf16_kernel<false>, smem, g, kflip, x, f, dx, db,
                                            dm, b, h, w, co, c, s);
  }
  if (dtype == 0) {
    if (co % KC_F) return (int)cudaErrorInvalidValue;
    const size_t smem = STAGE_BYTES_F + RED_BYTES_F;
    if (f)
      return (int)launch_dgrad<float>(dgrad_f32_kernel<true>, smem, g, kflip, x, f, dx, db, dm, b,
                                      h, w, co, c, s);
    return (int)launch_dgrad<float>(dgrad_f32_kernel<false>, smem, g, kflip, x, f, dx, db, dm, b,
                                    h, w, co, c, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Which kernel conv_bn_dgrad launches for this static shape and dtype (c: the
// channels of x and dx, co: those of g): 0 = the f32 FMA kernel, 1 = the bf16
// wmma row tile (8 rows x 128 columns x 64 channels), else the tile width TW
// of the pipelined wgmma kernel (256 / TW rows x TW columns x 128 channels);
// -1 = not taken.
extern "C" int conv_bn_dgrad_variant(int h, int w, int c, int co, int dtype) {
  if (c % TN) return -1;
  if (dtype == 0) return co % KC_F ? -1 : 0;
  if (dtype != 1) return -1;
  if (c % mm::TNB == 0 && co % mm::KC == 0) return mm::pick_tile_width(h, w);
  return co % KC_H ? -1 : 1;
}
