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
// 2*(C + Co) bytes per pixel read, and for wgrad a small f32 output).
//
// Design (simple implicit GEMMs; wgmma/TMA pipelines are later work):
//  * dgrad is the forward's tile code (conv_tile.cuh) on g with kflip and no
//    prologue, with another epilogue; dbias/dmul are per-thread partials kept
//    across the block's rows, one shared-memory reduction and one atomicAdd
//    per channel per block into zeroed outputs (the TPU kernel's sequential
//    grid added into resident vectors).
//  * wgrad: the TPU kernel adds into one resident (9C, Co) output across a
//    sequential grid.  Here the reduction dimension, the B*H*W pixels, is
//    SPLIT: a block owns an output tile (9 taps x KC input channels x TN
//    output channels) and a contiguous range of pixel segments (WG_TM
//    consecutive pixels of one image row), keeps the tile in registers over
//    its whole range (bf16: nine 16x16 wmma f32 accumulators per warp, A^T
//    read from the staged rows as a col-major fragment at the tap's pixel
//    offset; f32: 9 x 4 FMA accumulators per thread), and adds it with f32
//    atomicAdd into the ZEROED output at the end.  The number of splits is
//    chosen so that about four blocks per SM exist whatever the tile count
//    (dec_l5: 8 tiles; dec_l2.conv1: 96).  The order of the atomics changes
//    from run to run, so dW is reproducible only to f32 sum-order noise
//    (about 1e-6 of sum |terms|; the callers compare at 1e-3 of max |dW|).

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

// g: (b, h, w, co) contiguous; kflip: (9co, c) contiguous, same dtype as g;
// x: (b, h, w, c) the forward's raw input (read only with a fold); fold: (3,
// c) f32 or NULL; dx: (b, h, w, c); dbias, dmul: (c,) f32, ZEROED by the
// caller and untouched without a fold.  dtype 0 = float32 (co % 16 == 0), 1 =
// bfloat16 (co % 32 == 0); c % 64 == 0 for both.
extern "C" int conv_bn_dgrad(const void* g, const void* kflip, const void* x, const void* fold,
                             void* dx, void* dbias, void* dmul, int b, int h, int w, int co,
                             int c, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)fold;
  float* db = (float*)dbias;
  float* dm = (float*)dmul;
  if (c % TN) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
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
