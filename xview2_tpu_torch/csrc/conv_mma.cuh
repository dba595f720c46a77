// Pipelined bf16 implicit-GEMM tile of the 3x3 SAME convolution for Hopper:
// the main loop of two kernels, each with its own epilogue functor on the
// same accumulators: the fused conv+BN forward (K2, fused_conv.cu) and the
// input gradient (K5, fused_conv_bwd.cu), which is the same convolution on
// the cotangent with the flipped kernel.  Also the PTX wrappers (cp.async,
// ldmatrix, mma.sync, wgmma, red.v2), the swizzled operand layout that the
// weight gradient (K4) shares, the quad transpose of the 16-byte epilogues,
// and the host-side choice of the tile width and the persistent grid.
//
// A block of 256 threads (two warpgroups) works on one tile at a time: TP =
// 256 output pixels, shaped R rows x TW columns (TW = 128, 64, 32 or 16; R =
// 256 / TW), and TNB = 128 output channels.  Blocks are persistent: one per
// SM, each walking over many tiles with its ring of stages running on from
// one tile into the next, so that a tile's epilogue overlaps the next one's
// copies.  The reduction walks the input channels in chunks of KC = 16; one
// pipeline stage holds, for one chunk,
//   * the halo patch: (R + 2) x (TW + 2) pixels x 16 channels, pixel stride
//     48 bytes, so that the eight 16-byte rows of an ldmatrix fall on eight
//     different bank groups, and
//   * the nine taps' (16 x 128) weight slabs in the 128-byte-swizzled layout
//     that a wgmma shared-memory descriptor reads (wgmma_desc_b).
// Three stages form a ring filled by cp.async (16 bytes, zero fill outside
// the image: the SAME halo costs nothing) two chunks ahead of the tensor
// cores, with one __syncthreads per chunk.  All nine taps and all R rows of
// the tile run off the patch, so each input row and each weight slab is
// staged once per block tile.
//
// The MMA is wgmma.mma_async.m64n128k16 in its register-A form.  The one-pixel
// shift of a tap cannot be put into a swizzled descriptor, so the SHIFTED
// operand, the activations, goes through registers: ldmatrix takes any
// 16-byte-aligned row, a tap is a pointer offset into the patch, and the
// fragment of a warp's 16 rows is the A fragment wgmma wants.  The UNSHIFTED
// operand, the weights, is read from shared memory by the tensor cores
// themselves.  Each warpgroup owns 128 pixels x 128 channels (two m64 blocks,
// 128 f32 accumulators a thread); three taps are in flight, their A
// fragments in three register sets.
//
// With a fold, every thread applies the prologue in place to exactly the
// 16-byte pieces it copied itself (its own cp.async results are visible to it
// after wait_group): once per element, the halo stays zero.  It does so for
// chunk kc + 1 early in chunk kc, behind three taps of queued MMAs, so the
// tensor cores work through it.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace xv {
namespace mm {

constexpr int THREADS = 256;
constexpr int TP = 256;        // output pixels per block tile
constexpr int TNB = 128;       // output channels per block tile
constexpr int KC = 16;         // input channels per pipeline stage
constexpr int LDA = KC + 8;    // 24 halves = 48 bytes per staged pixel
constexpr int STAGES = 3;
constexpr int WB_TAP = 4096;   // bytes of one tap's (16 x 128) swizzled weight slab

constexpr int align1024i(int n) { return (n + 1023) / 1024 * 1024; }

template <int TW>
struct Tile {
  static_assert(TW % 16 == 0 && TP % TW == 0, "an m16 fragment must lie in one image row");
  static constexpr int R = TP / TW;               // output rows
  static constexpr int PW = TW + 2;               // patch columns
  static constexpr int NPIX = (R + 2) * PW;       // patch pixels
  static constexpr int A_VEC = NPIX * 2;          // 16-byte pieces of the patch
  static constexpr int A_IT = (A_VEC + THREADS - 1) / THREADS;
  static constexpr int A_BYTES = align1024i(NPIX * LDA * 2);  // the slabs behind it: 1024-aligned
  static constexpr int STAGE = A_BYTES + 9 * WB_TAP;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // room to align the ring to 1024 bytes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, one warp: m16n8k16 in bf16 with f32 accumulators (a: the
// ldmatrix_x4 fragment of 16 rows x 16 k; b: rows 2*(lane%4) + {0, 1} and
// + 8 of column lane/4, as bf16 pairs; d[e]: row lane/4 + 8*(e/2), column
// (lane%4)*2 + e%2)
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Transpose of a 4 x 4 matrix of 32-bit words over the four lanes of a quad
// (q = lane % 4): afterwards lane q's v[k] is what lane k's v[q] was.  Two
// shuffle rounds, one per bit of q; a transpose is its own inverse.  The
// epilogues use it to turn the accumulator fragment's channel pairs of four
// n8 tiles into one 16-byte row piece a lane, and back.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1)  // exchange lane bit with word bit
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!(k & bit)) {
        const bool up = q & bit;
        const uint32_t got = __shfl_xor_sync(0xffffffffu, up ? v[k] : v[k | bit], bit);
        if (up) v[k] = got; else v[k | bit] = got;
      }
}

// two adjacent floats added to device memory in one reduction (8-byte aligned)
__device__ __forceinline__ void red_add_f32x2(float* addr, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(addr), "f"(a), "f"(b) : "memory");
}

// Warpgroup MMA, register-A form: d (64 x N f32; this thread holds, for each
// n8 tile j, d[4j + e] = row 16*warp + lane/4 + 8*(e/2), column 8j + (lane%4)*2
// + e%2) += a (64 x 16 bf16: each warp gives the m16n8k16 A fragment of its 16
// rows) * b (16 x N bf16 in shared memory behind desc_b, N-contiguous); with
// accumulate == 0, d = a * b instead.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
// ask for the 128-byte line at p to be brought into L2; nothing waits for it
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// writes of this thread to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory descriptor of a (16 x N) bf16 B operand stored N-contiguous
// ("MN-major") under the 128-byte swizzle: groups of 64 columns, lbo bytes
// apart (leading byte offset); in a group 16 rows of 128 bytes, the 16-byte
// piece p of row k at piece p ^ (k % 8) (swizzled_piece); the two 8-row
// halves 1024 bytes apart (stride byte offset).  addr is 1024-byte aligned.
__device__ __forceinline__ uint64_t wgmma_desc_b(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// byte offset of piece p (8 columns) of row k inside a 64-column group
__device__ __forceinline__ uint32_t swizzled_piece(int k, int p) {
  return (uint32_t)(k * 128 + ((p ^ (k & 7)) << 4));
}

// The prologue on the 8 bf16 values of one staged 16-byte piece, in place;
// mean, mul, bias: the fold of its 8 channels, rounded to bf16.
__device__ __forceinline__ void prologue_piece(unsigned char* piece, const uint4& mean,
                                               const uint4& mul, const uint4& bias,
                                               __nv_bfloat162 slope) {
  uint4 v = *reinterpret_cast<uint4*>(piece);
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162* m = reinterpret_cast<const __nv_bfloat162*>(&mean);
  const __nv_bfloat162* s = reinterpret_cast<const __nv_bfloat162*>(&mul);
  const __nv_bfloat162* t = reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = prologue2(e[k], m[k], s[k], t[k], slope);
  *reinterpret_cast<uint4*>(piece) = v;
}

// Shape of one launch: the image, the channels and how it is cut into tiles.
// Tile t = ((image * row_groups + row group) * col_tiles + column tile) * n_co
// + channel tile: the channel tiles of one patch are neighbours, so the
// blocks that share a patch run together and find it in L2.
struct ConvGeom {
  int h, w, cin, cout, row_groups, col_tiles, n_co, tiles;
};

template <int TW>
__device__ __forceinline__ void tile_origin(const ConvGeom& gm, int t, int& b, int& y0, int& x0,
                                            int& n0) {
  n0 = (t % gm.n_co) * TNB;
  t /= gm.n_co;
  x0 = (t % gm.col_tiles) * TW;
  t /= gm.col_tiles;
  y0 = (t % gm.row_groups) * Tile<TW>::R;
  b = t / gm.row_groups;
}

// No work at the start of a tile (the default of conv_tiles_wgmma's hook).
struct NoTileStart {
  __device__ __forceinline__ void operator()(int, int, int, int) const {}
};

// The persistent main loop: this block computes tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... and hands each finished tile to epi(acc, b, y0, x0, n0), which
// every thread of the block calls (it may use __syncthreads).  start(b, y0, x0,
// n0) is called once a tile's first chunk has gone through the tensor cores,
// so that an epilogue can ask for its other operands early (K5 prefetches x).
// The ring runs on across tiles: while a tile's epilogue runs, the first two
// chunks of the next tile are already on their way.  The block's two
// warpgroups own 128 pixels each, as two m64 blocks; warp w of a warpgroup
// holds rows 16w..16w+15 of each.  acc[mb][4j + e]: pixel wg*128 + mb*64 +
// 16w + lane/4 + 8*(e/2) of the R x TW tile at (y0, x0) of image b, channel
// n0 + 8j + (lane%4)*2 + e%2, summed over all of cin and the nine taps.
// smem_raw: Tile<TW>::SMEM bytes; fs (shared memory, (3, cin) in bf16) is read
// only with FOLD and must be visible to the block on entry.  x is (B, h, w,
// cin), kmat (9*cin, cout).
template <int TW, bool FOLD, typename Epilogue, typename TileStart = NoTileStart>
__device__ __forceinline__ void conv_tiles_wgmma(unsigned char* smem_raw,
                                                 const __nv_bfloat16* __restrict__ x,
                                                 const __nv_bfloat16* __restrict__ kmat,
                                                 const __nv_bfloat16* fs, const ConvGeom& gm,
                                                 Epilogue epi, TileStart start = TileStart()) {
  using T = Tile<TW>;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t sraw = smem_u32(smem_raw);
  const uint32_t sbase = (sraw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (sbase - sraw);
  const __nv_bfloat162 slope = __float2bfloat162_rn(kLeakySlope);
  const int nk = gm.cin / KC;
  const int my_tiles = (gm.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * nk;  // pipeline stages of this block

  // this thread's pieces of a stage.  Patch: pieces tid + i*THREADS (pixel, 8-
  // channel half); their destinations do not depend on the tile, their sources
  // and in-image flags do (asrc, in_load: of the tile being loaded).  Weights:
  // tap t, channel row tid / 16, 8 channels at tid % 16.
  uint32_t adst[T::A_IT];
#pragma unroll
  for (int i = 0; i < T::A_IT; ++i) {
    const int v = tid + i * THREADS;
    adst[i] = (uint32_t)((v >> 1) * LDA * 2 + (v & 1) * 16);
  }
  const int bk = tid >> 4, bn = tid & 15;
  const uint32_t bdst = (uint32_t)(T::A_BYTES + (bn >> 3) * 2048) + swizzled_piece(bk, bn & 7);
  const __nv_bfloat16* asrc[T::A_IT];
  const __nv_bfloat16* bsrc = kmat;
  uint32_t in_load = 0, in_before = 0;  // in-image flags: loaded tile, the one before it
  int load_tile = -1, load_kc = 0;     // position of the next stage to load

  auto load_stage = [&]() {  // the next stage, into its slot of the ring
    if (load_kc == 0) {
      ++load_tile;
      int b, y0, x0, n0;
      tile_origin<TW>(gm, (int)blockIdx.x + load_tile * (int)gridDim.x, b, y0, x0, n0);
      in_before = in_load;
      in_load = 0;
#pragma unroll
      for (int i = 0; i < T::A_IT; ++i) {
        const int v = tid + i * THREADS;
        const int pix = v >> 1;
        const int pr = pix / T::PW, pc = pix - pr * T::PW;
        const int yy = y0 + pr - 1, xx = x0 + pc - 1;
        const bool in = v < T::A_VEC && yy >= 0 && yy < gm.h && xx >= 0 && xx < gm.w;
        in_load |= (uint32_t)in << i;
        asrc[i] = in ? x + (((size_t)b * gm.h + yy) * gm.w + xx) * gm.cin + (v & 1) * 8 : x;
      }
      bsrc = kmat + (size_t)bk * gm.cout + n0 + bn * 8;
    }
    const int c0 = load_kc * KC;
    const uint32_t st = sbase + (uint32_t)(((load_tile * nk + load_kc) % STAGES) * T::STAGE);
#pragma unroll
    for (int i = 0; i < T::A_IT; ++i)
      if (tid + i * THREADS < T::A_VEC)
        cp_async16(st + adst[i], asrc[i] + c0, (in_load >> i) & 1);
#pragma unroll
    for (int t = 0; t < 9; ++t)
      cp_async16(st + bdst + (uint32_t)(t * WB_TAP),
                 bsrc + ((size_t)t * gm.cin + c0) * gm.cout, true);
    if (++load_kc == nk) load_kc = 0;
  };
  // this thread's landed pieces of stage q (chunk kc of its tile): the prologue
  auto fold_own = [&](int q, int kc, bool of_load_tile) {
    if (FOLD) {
      const uint32_t in = of_load_tile ? in_load : in_before;
      const __nv_bfloat16* f = fs + kc * KC + (tid & 1) * 8;
      const uint4 mean = *reinterpret_cast<const uint4*>(f);
      const uint4 mul = *reinterpret_cast<const uint4*>(f + gm.cin);
      const uint4 bias = *reinterpret_cast<const uint4*>(f + 2 * gm.cin);
#pragma unroll
      for (int i = 0; i < T::A_IT; ++i)
        if ((in >> i) & 1)
          prologue_piece(smem + (q % STAGES) * T::STAGE + adst[i], mean, mul, bias, slope);
    }
    fence_async_shared();  // the weights this thread copied, before wgmma reads them
  };

  // ldmatrix addresses inside a stage: lane -> row of the 16 and 8-column half
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  uint32_t a_off[2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    const int p0 = (warp >> 2) * 128 + mb * 64 + (warp & 3) * 16;
    a_off[mb] = (uint32_t)((((p0 / TW) * T::PW + p0 % TW + lrow) * LDA + lcol) * 2);
  }

  float acc[2][64];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[mb][e] = 0.f;
  // Stage q + 2 is copied during stage q, into the slot of stage q - 1, whose
  // MMAs every warp has waited for before the barrier of stage q.  (Copying
  // only one stage ahead into the third slot, so that the tensor cores need
  // not drain at the barrier, measured 1.5% slower; a second barrier 5%.)
  if (total > 0) load_stage();
  cp_async_commit();
  if (total > 1) load_stage();
  cp_async_commit();
  cp_async_wait<1>();
  if (total > 0) fold_own(0, 0, load_tile == 0);
  int tile = 0, kc = 0;  // position of stage q
  for (int q = 0; q < total; ++q) {
    __syncthreads();  // stage q is whole
    const uint32_t st = sbase + (uint32_t)((q % STAGES) * T::STAGE);
    uint32_t a[3][2][4];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint32_t tap = (uint32_t)((((t / 3) * T::PW + t % 3) * LDA) * 2);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) ldmatrix_x4(a[t % 3][mb], st + a_off[mb] + tap);
      const uint64_t desc = wgmma_desc_b(st + (uint32_t)(T::A_BYTES + t * WB_TAP), 2048);
      const int accumulate = (t > 0 || kc > 0) ? 1 : 0;  // a tile starts from zero
      wgmma_fence();
      wgmma_m64n128k16(acc[0], a[t % 3][0], desc, accumulate);
      wgmma_m64n128k16(acc[1], a[t % 3][1], desc, accumulate);
      wgmma_commit();
      if (t == 1) {  // refill the slot of stage q - 1 while the tensor cores are busy
        if (q + 2 < total) load_stage();
        cp_async_commit();
      }
      if (t == 2) {  // stage q + 1 has landed: the prologue on it behind three queued taps
        cp_async_wait<1>();
        if (q + 1 < total) {
          const bool next_tile = kc + 1 == nk;
          fold_own(q + 1, next_tile ? 0 : kc + 1, load_tile == tile + (next_tile ? 1 : 0));
        }
      }
      wgmma_wait<2>();  // tap t - 2 is done: its A registers are free for tap t + 1
    }
    wgmma_wait<0>();  // before the barrier that lets this slot be refilled
    if constexpr (!std::is_same<TileStart, NoTileStart>::value) {
      if (kc == 0) {
        int b, y0, x0, n0;
        tile_origin<TW>(gm, (int)blockIdx.x + tile * (int)gridDim.x, b, y0, x0, n0);
        start(b, y0, x0, n0);
      }
    }
    if (++kc == nk) {
      int b, y0, x0, n0;
      tile_origin<TW>(gm, (int)blockIdx.x + tile * (int)gridDim.x, b, y0, x0, n0);
      epi(acc, b, y0, x0, n0);
      kc = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------ host side
// Padded area of an H x W image under R x TW tiles, in pixels.
inline long long padded_area(int h, int w, int tw) {
  const int r = TP / tw;
  return (long long)((h + r - 1) / r * r) * ((w + tw - 1) / tw * tw);
}

// The tile width that wastes least of this image; the wider one on a tie.
inline int pick_tile_width(int h, int w) {
  int best = 128;
  for (int tw = 64; tw >= 16; tw /= 2)
    if (padded_area(h, w, tw) < padded_area(h, w, best)) best = tw;
  return best;
}

// The geometry of one launch of conv_tiles_wgmma<TW> over a (b, h, w, cin)
// input producing cout channels, and its persistent grid: one block per SM,
// fewer when there are fewer tiles (blocks = 0: nothing to do).
template <int TW>
cudaError_t conv_launch_shape(int b, int h, int w, int cin, int cout, ConvGeom& gm,
                              unsigned& blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  gm.h = h, gm.w = w, gm.cin = cin, gm.cout = cout;
  gm.row_groups = (h + Tile<TW>::R - 1) / Tile<TW>::R;
  gm.col_tiles = (w + TW - 1) / TW;
  gm.n_co = cout / TNB;
  const long long tiles = (long long)b * gm.row_groups * gm.col_tiles * gm.n_co;
  if (tiles > 0x7fffffffLL / (cin / KC)) return cudaErrorInvalidValue;  // stage counter is int
  gm.tiles = (int)tiles;
  blocks = (unsigned)(tiles < sms ? tiles : sms);
  return cudaSuccess;
}

}  // namespace mm
}  // namespace xv
