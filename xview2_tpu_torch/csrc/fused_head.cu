// Fused packed head: fold + LeakyReLU prologue, 1x1 GEMM, bias.
//
// Replaces the TPU kernel ops/packed_fused_conv.py::_head_kernel
// (_head_fwd_impl, reached through head_conv_fused).  Per pixel:
//   a   = prologue(x[p, :])                       (in T, see common.cuh)
//   acc = sum_c a[c] * T(kmat[c, o])               (f32 accumulation)
//   out = T(T(acc) + T(hbias[o]))                  (two roundings, as in JAX)
//
// Bound on the H100: bytes.  On the main path x is (16, 512, 512, 128) bf16
// (1.07 GB) and the output (16, 512, 512, 8) bf16; the GEMM is 8 FLOP per
// byte of x, far below the card's ratio, so all that counts is reading x at
// the memory rate: 0.34 ms at eval, 0.085 ms in training.  Covering the
// memory's latency at 3.35 TB/s takes tens of KB in flight per SM.
//
// Design.  Two kernels, chosen in the C entry point by the static shape and
// dtype only (head_conv_fused_variant reports the choice):
//  * bf16 with C in {16, 32, 64, 128} and Co in {8, 16, 32, 64} (the
//    localization path: C = 128, Co = 8), or C = 256 with Co in {8, 16} (the
//    Siamese head: two packed branches of 128, Co = 16), or Co = 4 at C = 128
//    and 256 (the single-logit CORAL and MSE heads): head_mma_kernel.
//    Persistent blocks of 256 threads, one per SM, walk tiles of 128
//    pixels.  A ring filled by cp.async (16 bytes a copy, zero fill past the
//    last pixel) keeps tiles in flight per SM: four stages (three tiles,
//    104 KB at C = 128) up to C = 128, three stages (two tiles, 135 KB) at
//    C = 256, where four would need 270 KB of the 227 KB a block may use.  The pixel stride
//    is padded by 16 bytes, so the eight rows of an ldmatrix fall on eight
//    bank groups.  Each thread applies the prologue in place to the pieces it
//    copied itself, in the packed bf16 arithmetic of prologue_piece
//    (bit-equal to the per-op rounding); one barrier per tile.  Each warp
//    then multiplies its 16 pixels with mma.sync.m16n8k16 in bf16, A from
//    the tile by ldmatrix, B (kmat rounded to bf16) held in registers for the
//    block's life (C/16 k-steps x Co/8 n8 tiles: 64 registers at C = 256,
//    Co = 16, hence Co <= 16 there), f32 accumulators.  The
//    epilogue rounds twice on bf16 pairs and gathers each pixel's eight
//    channels of an n8 tile into one lane by quad shuffles: one 16-byte store.
//    Co = 4 takes one n8 tile whose B fragment has four zero columns; the
//    quad's first two lanes hold the four real channels, gathered into one
//    8-byte store per pixel.
//    kmat, the fold and hbias are read once per block.
//  * everything else (float32, Co = 12, other C): head_kernel, a block
//    of 128 threads per 128 pixels, staging its tile with the prologue
//    applied per element in f32, then one pixel per thread against kmat in
//    shared memory by scalar FMA.
// On the H100 the mma kernel reads x at about 2.8 TB/s at eval size, 84% of
// the bound; six stages, or three with two blocks per SM, measured the same,
// so the bytes in flight no longer limit it.  Not done yet: TMA bulk copies
// of the tile (one instruction per tile).

#include <stdint.h>

#include "conv_mma.cuh"

namespace {

using namespace xv;

constexpr int TP = 128;  // pixels per block == threads per block

template <typename T, int CO>
__global__ void __launch_bounds__(TP) head_kernel(
    const T* __restrict__ x, const float* __restrict__ kmat, const float* __restrict__ fold,
    const float* __restrict__ hbias, T* __restrict__ out, long long npix, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = c + 4 / sizeof(T);  // pad by one 32-bit word: conflict-free rows
  float* ks = reinterpret_cast<float*>(smem_raw);  // (c, CO)
  float* fs = ks + c * CO;                         // mean, mul, bias (3, c), rounded to T
  T* tile = reinterpret_cast<T*>(fs + 3 * c);      // (TP, ld)

  const int tid = threadIdx.x;
  for (int i = tid; i < c * CO; i += TP) ks[i] = rnd<T>(kmat[i]);
  for (int i = tid; i < 3 * c; i += TP) fs[i] = rnd<T>(fold[i]);
  const float slope = rnd<T>(kLeakySlope);
  __syncthreads();

  const long long p0 = (long long)blockIdx.x * TP;
  const int np = (int)min((long long)TP, npix - p0);
  // stage: 16-byte vectors of VEC elements, in source order (coalesced)
  constexpr int VEC = 16 / sizeof(T);
  const int vec_per_pix = c / VEC;
  const uint4* src = reinterpret_cast<const uint4*>(x + p0 * c);
  for (int v = tid; v < np * vec_per_pix; v += TP) {
    const int p = v / vec_per_pix;
    const int c0 = (v - p * vec_per_pix) * VEC;
    uint4 raw = src[v];
    const T* e = reinterpret_cast<const T*>(&raw);
    T* dst = tile + p * ld + c0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = c0 + k;
      dst[k] = from_float<T>(prologue<T>(to_float(e[k]), fs[ch], fs[c + ch], fs[2 * c + ch], slope));
    }
  }
  __syncthreads();

  if (tid >= np) return;
  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;
  const T* row = tile + tid * ld;
  for (int k = 0; k < c; ++k) {
    const float a = to_float(row[k]);
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = fmaf(a, ks[k * CO + o], acc[o]);
  }
  T* dst = out + (p0 + tid) * CO;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const float y = rnd<T>(acc[o]);
    dst[o] = from_float<T>(__fadd_rn(y, rnd<T>(hbias[o])));
  }
}

template <typename T, int CO>
cudaError_t launch(const void* x, const float* kmat, const float* fold, const float* hbias,
                   void* out, long long npix, int c, cudaStream_t stream) {
  const size_t smem = (size_t)c * CO * 4 + 3 * (size_t)c * 4 +
                      (size_t)TP * (c + 4 / sizeof(T)) * sizeof(T);
  auto kern = head_kernel<T, CO>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (npix + TP - 1) / TP;
  if (blocks > 0)
    kern<<<(unsigned)blocks, TP, smem, stream>>>((const T*)x, kmat, fold, hbias, (T*)out, npix, c);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16, mma.sync, cp.async ring
constexpr int H_THREADS = 256;  // 8 warps, 16 pixels each per tile
constexpr int H_TP = 128;       // pixels per tile

__host__ __device__ inline int head_ldx(int c) { return 2 * c + 16; }  // bytes per staged pixel

// H_KMAX: k-steps of 16 channels the instantiation unrolls (8 for C <= 128,
// 16 for C = 256); H_STAGES: tiles in the ring, all but one in flight
template <int CO, int H_KMAX, int H_STAGES>
__global__ void __launch_bounds__(H_THREADS, 1) head_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ kmat,
    const float* __restrict__ fold, const float* __restrict__ hbias,
    __nv_bfloat16* __restrict__ out, long long npix, int c) {
  constexpr int NT = (CO + 7) / 8;  // n8 tiles (Co = 4: one, half of it zero)
  constexpr int NK = CO >= 8 ? 4 : CO / 2;  // lanes of a quad holding real channels
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = head_ldx(c);
  const int stage_bytes = H_TP * ldx;
  __nv_bfloat16* fs = reinterpret_cast<__nv_bfloat16*>(smem + H_STAGES * stage_bytes);  // (3, c)
  const uint32_t sbase = mm::smem_u32(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int ks = c / 16;
  for (int i = tid; i < 3 * c; i += H_THREADS) fs[i] = __float2bfloat16(fold[i]);

  // B fragments of kmat rounded to bf16, for the block's life: k-step s, n8
  // tile t: rows 16s + 2q, +1 (word 0) and + 8, + 9 (word 1) of column 8t + g
  uint32_t bfr[H_KMAX][NT][2];
#pragma unroll
  for (int s = 0; s < H_KMAX; ++s)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int hw = 0; hw < 2; ++hw) {
        bfr[s][t][hw] = 0u;
        const int k = 16 * s + 2 * q + 8 * hw, n = 8 * t + g;
        if (s < ks && n < CO) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(kmat[k * CO + n], kmat[(k + 1) * CO + n]);
          bfr[s][t][hw] = *reinterpret_cast<const uint32_t*>(&v);
        }
      }
  __nv_bfloat162 hb[NT];  // hbias rounded, channels 8t + 2q, +1 (zero past Co)
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int ch = 8 * t + 2 * q;
    hb[t] = ch < CO ? __floats2bfloat162_rn(hbias[ch], hbias[ch + 1])
                    : __floats2bfloat162_rn(0.f, 0.f);
  }
  __syncthreads();  // fs

  // this thread's pieces of a tile: v = tid + i * H_THREADS, pixel v / cv,
  // 8 channels at v % cv; cv = c / 8 divides H_THREADS, so the channels are
  // the same for all of them and the fold of those 8 stays in registers
  const int cv = c / 8;
  const int per = H_TP * cv / H_THREADS;  // == ks
  const int chunk = tid % cv;
  const uint4 fmean = *reinterpret_cast<const uint4*>(fs + chunk * 8);
  const uint4 fmul = *reinterpret_cast<const uint4*>(fs + c + chunk * 8);
  const uint4 fbias = *reinterpret_cast<const uint4*>(fs + 2 * c + chunk * 8);
  const __nv_bfloat162 slope = __float2bfloat162_rn(kLeakySlope);
  const int pix0 = tid / cv, pix_step = H_THREADS / cv;  // piece i: pixel pix0 + i * pix_step
  const uint32_t dst0 = (uint32_t)(pix0 * ldx + chunk * 16);
  const uint32_t dst_step = (uint32_t)(pix_step * ldx);

  const long long tiles = (npix + H_TP - 1) / H_TP;
  const int my_tiles = (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto tile_of = [&](int i) { return (long long)blockIdx.x + (long long)i * gridDim.x; };
  auto load = [&](int i) {
    const uint32_t st = sbase + (uint32_t)((i % H_STAGES) * stage_bytes);
    const long long p0 = tile_of(i) * H_TP;
#pragma unroll
    for (int j = 0; j < H_KMAX; ++j)
      if (j < per) {
        const long long p = p0 + pix0 + j * pix_step;
        const bool in = p < npix;
        mm::cp_async16(st + dst0 + j * dst_step, in ? x + p * c + chunk * 8 : x, in);
      }
  };

  // ldmatrix: lane -> row of the warp's 16 pixels and 8-channel half of a k-step
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off = (uint32_t)((warp * 16 + lrow) * ldx + (lane >> 4) * 16);

#pragma unroll
  for (int i = 0; i < H_STAGES - 1; ++i) {
    if (i < my_tiles) load(i);
    mm::cp_async_commit();
  }
  for (int i = 0; i < my_tiles; ++i) {
    mm::cp_async_wait<H_STAGES - 2>();  // this thread's pieces of tile i have landed
    unsigned char* st = smem + (i % H_STAGES) * stage_bytes;
    const long long p0 = tile_of(i) * H_TP;
#pragma unroll
    for (int j = 0; j < H_KMAX; ++j)
      if (j < per && p0 + pix0 + j * pix_step < npix)
        mm::prologue_piece(st + dst0 + j * dst_step, fmean, fmul, fbias, slope);
    // tile i is whole and activated; every warp is done with tile i - 1,
    // whose slot the next load refills
    __syncthreads();
    if (i + H_STAGES - 1 < my_tiles) load(i + H_STAGES - 1);
    mm::cp_async_commit();

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    const uint32_t a_addr = sbase + (uint32_t)((i % H_STAGES) * stage_bytes) + a_off;
#pragma unroll
    for (int s = 0; s < H_KMAX; ++s)
      if (s < ks) {
        uint32_t a[4];
        mm::ldmatrix_x4(a, a_addr + s * 32);
#pragma unroll
        for (int t = 0; t < NT; ++t) mm::mma_m16n8k16_bf16(acc[t], a, bfr[s][t]);
      }

    // rows g and g + 8 of the warp's 16: lane q of a quad holds channels 8t +
    // 2q, +1 of both.  Lane 0 of the quad gathers row g's four pairs, lane 1
    // row g + 8's, each into one 16-byte store.
    const long long prow = p0 + warp * 16 + g + (q & 1) * 8;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const __nv_bfloat162 o0 = __hadd2_rn(__floats2bfloat162_rn(acc[t][0], acc[t][1]), hb[t]);
      const __nv_bfloat162 o1 = __hadd2_rn(__floats2bfloat162_rn(acc[t][2], acc[t][3]), hb[t]);
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(&o0);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(&o1);
      uint32_t wv[4];
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const uint32_t w0 = __shfl_sync(0xffffffffu, r0, (lane & ~3) | k);
        const uint32_t w1 = __shfl_sync(0xffffffffu, r1, (lane & ~3) | k);
        wv[k] = (q & 1) ? w1 : w0;
      }
      if constexpr (CO >= 8) {
        if (q < 2 && prow < npix)
          *reinterpret_cast<uint4*>(out + prow * CO + 8 * t) =
              make_uint4(wv[0], wv[1], wv[2], wv[3]);
      } else {
        if (q < 2 && prow < npix)
          *reinterpret_cast<uint2*>(out + prow * CO) = make_uint2(wv[0], wv[1]);
      }
    }
  }
  mm::cp_async_wait<0>();
}

template <int CO, int H_KMAX, int H_STAGES>
cudaError_t launch_mma(const void* x, const float* kmat, const float* fold, const float* hbias,
                       void* out, long long npix, int c, cudaStream_t stream) {
  const size_t smem = (size_t)H_STAGES * H_TP * head_ldx(c) + 3ull * c * 2;
  auto kern = head_mma_kernel<CO, H_KMAX, H_STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long tiles = (npix + H_TP - 1) / H_TP;
  if (tiles > 0)  // one persistent block per SM
    kern<<<(unsigned)(tiles < sms ? tiles : sms), H_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)x, kmat, fold, hbias, (__nv_bfloat16*)out, npix, c);
  return cudaGetLastError();
}

// C and Co that head_mma_kernel takes
bool mma_takes(int c, int co) {
  if (co == 4) return c == 128 || c == 256;
  if (c == 256) return co == 8 || co == 16;
  return (c == 16 || c == 32 || c == 64 || c == 128) &&
         (co == 8 || co == 16 || co == 32 || co == 64);
}

template <typename T>
cudaError_t dispatch(const void* x, const float* kmat, const float* fold, const float* hbias,
                     void* out, long long npix, int c, int co, cudaStream_t s) {
  switch (co) {
    case 4: return launch<T, 4>(x, kmat, fold, hbias, out, npix, c, s);
    case 8: return launch<T, 8>(x, kmat, fold, hbias, out, npix, c, s);
    case 12: return launch<T, 12>(x, kmat, fold, hbias, out, npix, c, s);
    case 16: return launch<T, 16>(x, kmat, fold, hbias, out, npix, c, s);
    case 32: return launch<T, 32>(x, kmat, fold, hbias, out, npix, c, s);
    case 64: return launch<T, 64>(x, kmat, fold, hbias, out, npix, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (npix, c) contiguous T; kmat: (c, co) f32; fold: (3, c) f32 = mean, mul,
// bias; hbias: (co,) f32; out: (npix, co) contiguous T.  dtype 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int head_conv_fused(const void* x, const void* kmat, const void* fold,
                               const void* hbias, void* out, long long npix, int c, int co,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* k = (const float*)kmat;
  const float* f = (const float*)fold;
  const float* hb = (const float*)hbias;
  if (dtype == 0) return (int)dispatch<float>(x, k, f, hb, out, npix, c, co, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (mma_takes(c, co) && c == 256) {
    switch (co) {
      case 4: return (int)launch_mma<4, 16, 3>(x, k, f, hb, out, npix, c, s);
      case 8: return (int)launch_mma<8, 16, 3>(x, k, f, hb, out, npix, c, s);
      default: return (int)launch_mma<16, 16, 3>(x, k, f, hb, out, npix, c, s);
    }
  }
  if (mma_takes(c, co)) {
    switch (co) {
      case 4: return (int)launch_mma<4, 8, 4>(x, k, f, hb, out, npix, c, s);
      case 8: return (int)launch_mma<8, 8, 4>(x, k, f, hb, out, npix, c, s);
      case 16: return (int)launch_mma<16, 8, 4>(x, k, f, hb, out, npix, c, s);
      case 32: return (int)launch_mma<32, 8, 4>(x, k, f, hb, out, npix, c, s);
      default: return (int)launch_mma<64, 8, 4>(x, k, f, hb, out, npix, c, s);
    }
  }
  return (int)dispatch<__nv_bfloat16>(x, k, f, hb, out, npix, c, co, s);
}

// Which kernel head_conv_fused launches for this static shape and dtype (h
// and w do not matter; the signature is that of the conv kernels' queries):
// 0 = the per-pixel FMA kernel, 1 = the bf16 mma.sync kernel with the
// 4-stage cp.async ring, 2 = the same with 3 stages (C = 256); -1 = not taken.
extern "C" int head_conv_fused_variant(int h, int w, int c, int co, int dtype) {
  (void)h, (void)w;
  if (dtype == 1 && mma_takes(c, co)) return c == 256 ? 2 : 1;
  if (dtype != 0 && dtype != 1) return -1;
  const bool co_ok = co == 4 || co == 8 || co == 12 || co == 16 || co == 32 || co == 64;
  return co_ok ? 0 : -1;
}
