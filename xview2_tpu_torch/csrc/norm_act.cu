// The eval BatchNorm epilogue of the stock call sites in one pass:
//   out = act(((x - mean) * mul) + bias)               act: none, relu or leaky
//   out = relu((((x - mean) * mul) + bias) + res)      the bottleneck's tail
// on an NHWC map seen as rows of C channels, with the f32 fold vectors
// mean, mul, bias of C entries.
//
// Replaces no TPU kernel: XLA fuses these elementwise ops on the TPU, while
// eager PyTorch runs each as a pass of its own over the map, and with the
// per-channel vectors broadcast (stride 0) on its unvectorised legacy path.
// It is bit-equal to that eager chain (models/layers.py norm_act, then
// F.relu(out + res)): the vectors are rounded to T as .to(T) rounds them
// (RN), every op rounds to T, the ReLU is ATen's clamp_min(y, 0) (NaN kept,
// fmaxf otherwise) and the leaky ReLU ATen's y > 0 ? y : y * slope.  In bf16
// the affine and the residual add run in the card's packed bf16 arithmetic,
// bit-equal to one rounding per op (see xv::prologue2 in common.cuh); the
// _rn forms keep nvcc from contracting them into an FMA.
//
// Bound on the H100: bytes, one read of x (and res) and one write of out,
// 4 B (6 B with res) an element in bf16.  A thread owns one 16-byte vector of
// channels (8 bf16 or 4 f32) at the same place in every row it visits, so it
// rounds its share of the fold vectors once, into registers, and never
// divides an index in its loop; a block holds whole rows (rpb rows of C / V
// threads) and walks UNROLL rows per thread, issuing all their 16-byte loads
// before the first store.  Loads and stores are streaming (evict-first): the
// maps are far larger than L2.  A C that is no multiple of the vector width,
// or a misaligned pointer, takes the scalar form of the same loop.
//
// A map laid out in another order of its axes (the channel axis not
// innermost: a conv's NCHW output seen as NHWC, as the pyramid pooling's
// small maps and the interpolating decoder's convs give) is read and written
// in its own layout, as the eager chain keeps it: runs of `inner` elements
// (the channel axis's stride) share one channel, so element k has channel
// (k / inner) % C.  That form (norm_act_strided_elementwise_kernel) takes a
// 16-byte vector of one channel where inner is a multiple of its width, and
// one element otherwise; no cell's hot path runs it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kNone = 0, kRelu = 1, kLeaky = 2;
constexpr int MAX_THREADS = 1024;  // one block holds a row: at most 1024 vectors a row
constexpr int TARGET_THREADS = 256;
constexpr int UNROLL = 4;
constexpr int STRIDED_THREADS = 256;
constexpr long long MAX_GRID = 1 << 16;

// eager's activations on a value already rounded to T (ATen's CUDA kernels
// compute in float and round the result to T; relu returns a NaN as it is)
template <typename T, int ACT>
__device__ __forceinline__ T activate(float y, T y_t, float slope) {
  if (ACT == kRelu) return isnan(y) ? y_t : xv::from_float<T>(fmaxf(y, 0.f));
  if (ACT == kLeaky) return xv::from_float<T>(y > 0.f ? y : __fmul_rn(y, slope));
  return y_t;
}

// one bf16 pair: affine, residual, activation
template <int ACT, bool RES>
__device__ __forceinline__ uint32_t pair(uint32_t xb, uint32_t rb, __nv_bfloat162 m,
                                         __nv_bfloat162 s, __nv_bfloat162 b, float slope) {
  __nv_bfloat162 y = __hadd2_rn(__hmul2_rn(__hsub2_rn(*reinterpret_cast<__nv_bfloat162*>(&xb),
                                                      m), s), b);
  if (RES) y = __hadd2_rn(y, *reinterpret_cast<__nv_bfloat162*>(&rb));
  if (ACT != kNone) {
    y = __halves2bfloat162(activate<__nv_bfloat16, ACT>(__low2float(y), __low2bfloat16(y), slope),
                           activate<__nv_bfloat16, ACT>(__high2float(y), __high2bfloat16(y),
                                                        slope));
  }
  return *reinterpret_cast<uint32_t*>(&y);
}

// one f32 value
template <int ACT, bool RES>
__device__ __forceinline__ float one(float x, float r, float m, float s, float b, float slope) {
  float y = __fadd_rn(__fmul_rn(__fsub_rn(x, m), s), b);
  if (RES) y = __fadd_rn(y, r);
  return activate<float, ACT>(y, y, slope);
}

// A thread's share of the fold, rounded to T: V channels (V = 8 bf16 or 4
// f32 in 16 bytes; V = 1 the scalar form, kept as float).
template <typename T, int V> struct Fold;

template <> struct Fold<__nv_bfloat16, 8> {
  __nv_bfloat162 m[4], s[4], b[4];
  __device__ void load(const float* mean, const float* mul, const float* bias, int c0) {
    for (int i = 0; i < 4; ++i) {
      m[i] = __floats2bfloat162_rn(mean[c0 + 2 * i], mean[c0 + 2 * i + 1]);
      s[i] = __floats2bfloat162_rn(mul[c0 + 2 * i], mul[c0 + 2 * i + 1]);
      b[i] = __floats2bfloat162_rn(bias[c0 + 2 * i], bias[c0 + 2 * i + 1]);
    }
  }
  __device__ void broadcast(const float* mean, const float* mul, const float* bias, int ch) {
    for (int i = 0; i < 4; ++i) {
      m[i] = __float2bfloat162_rn(mean[ch]);
      s[i] = __float2bfloat162_rn(mul[ch]);
      b[i] = __float2bfloat162_rn(bias[ch]);
    }
  }
  template <int ACT, bool RES>
  __device__ uint4 apply(uint4 x, uint4 r, float slope) const {
    return make_uint4(pair<ACT, RES>(x.x, r.x, m[0], s[0], b[0], slope),
                      pair<ACT, RES>(x.y, r.y, m[1], s[1], b[1], slope),
                      pair<ACT, RES>(x.z, r.z, m[2], s[2], b[2], slope),
                      pair<ACT, RES>(x.w, r.w, m[3], s[3], b[3], slope));
  }
};

template <> struct Fold<float, 4> {
  float m[4], s[4], b[4];
  __device__ void load(const float* mean, const float* mul, const float* bias, int c0) {
    for (int i = 0; i < 4; ++i) {
      m[i] = mean[c0 + i];
      s[i] = mul[c0 + i];
      b[i] = bias[c0 + i];
    }
  }
  __device__ void broadcast(const float* mean, const float* mul, const float* bias, int ch) {
    for (int i = 0; i < 4; ++i) {
      m[i] = mean[ch];
      s[i] = mul[ch];
      b[i] = bias[ch];
    }
  }
  template <int ACT, bool RES>
  __device__ uint4 apply(uint4 x, uint4 r, float slope) const {
    const float4 xf = *reinterpret_cast<float4*>(&x), rf = *reinterpret_cast<float4*>(&r);
    const float4 y = make_float4(one<ACT, RES>(xf.x, rf.x, m[0], s[0], b[0], slope),
                                 one<ACT, RES>(xf.y, rf.y, m[1], s[1], b[1], slope),
                                 one<ACT, RES>(xf.z, rf.z, m[2], s[2], b[2], slope),
                                 one<ACT, RES>(xf.w, rf.w, m[3], s[3], b[3], slope));
    return *reinterpret_cast<const uint4*>(&y);
  }
};

template <typename T> struct Fold<T, 1> {
  float m, s, b;  // rounded to T
  __device__ void load(const float* mean, const float* mul, const float* bias, int c0) {
    m = xv::rnd<T>(mean[c0]);
    s = xv::rnd<T>(mul[c0]);
    b = xv::rnd<T>(bias[c0]);
  }
  __device__ void broadcast(const float* mean, const float* mul, const float* bias, int ch) {
    load(mean, mul, bias, ch);
  }
  template <int ACT, bool RES>
  __device__ T apply(T x, T r, float slope) const {
    float y = xv::rnd<T>(__fsub_rn(xv::to_float(x), m));
    y = xv::rnd<T>(__fmul_rn(y, s));
    y = xv::rnd<T>(__fadd_rn(y, b));
    if (RES) y = xv::rnd<T>(__fadd_rn(y, xv::to_float(r)));
    return activate<T, ACT>(y, xv::from_float<T>(y), slope);
  }
};

template <typename T, int V>
using Vec = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_cs(const T* p) {
  if constexpr (V == 1) {
    return *p;
  } else {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_cs(T* p, Vec<T, V> v) {
  if constexpr (V == 1) {
    *p = v;
  } else {
    __stcs(reinterpret_cast<uint4*>(p), v);
  }
}

// blockDim.x = rpb * (c / V); thread t owns the vector of channels t % (c / V)
// of row t / (c / V) of each group of rpb rows it visits.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(MAX_THREADS)
    norm_act_elementwise_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                const float* __restrict__ mean, const float* __restrict__ mul,
                                const float* __restrict__ bias, T* __restrict__ out,
                                long long rows, int c, int rpb, float slope) {
  const int vecs = c / V;
  const int cv = (int)threadIdx.x % vecs;
  const long long r0 = (int)threadIdx.x / vecs;
  Fold<T, V> fold;
  fold.load(mean, mul, bias, cv * V);
  const long long group = (long long)rpb * UNROLL;  // rows a block takes at once
  for (long long base = (long long)blockIdx.x * group; base < rows;
       base += (long long)gridDim.x * group) {
    Vec<T, V> xv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = base + u * rpb + r0;
      if (row < rows) {
        const long long at = row * c + cv * V;
        xv[u] = load_cs<T, V>(x + at);
        if (RES) rv[u] = load_cs<T, V>(res + at);
        else rv[u] = xv[u];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = base + u * rpb + r0;
      if (row < rows) {
        store_cs<T, V>(out + row * c + cv * V,
                       fold.template apply<ACT, RES>(xv[u], rv[u], slope));
      }
    }
  }
}

// The channel axis not innermost: n vectors of V elements, `inner` vectors
// of one channel in a run; a thread takes one vector at a time.
template <typename T, int V, int ACT, bool RES>
__global__ void __launch_bounds__(STRIDED_THREADS)
    norm_act_strided_elementwise_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                        const float* __restrict__ mean,
                                        const float* __restrict__ mul,
                                        const float* __restrict__ bias, T* __restrict__ out,
                                        long long n, long long inner, int c, float slope) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    Fold<T, V> fold;
    fold.broadcast(mean, mul, bias, (int)((i / inner) % c));
    const Vec<T, V> xv = load_cs<T, V>(x + i * V);
    Vec<T, V> rv = xv;
    if (RES) rv = load_cs<T, V>(res + i * V);
    store_cs<T, V>(out + i * V, fold.template apply<ACT, RES>(xv, rv, slope));
  }
}

// inner: the channel axis's stride in elements (1: channels innermost)
template <typename T, int V, int ACT, bool RES>
cudaError_t launch(const void* x, const void* res, const float* mean, const float* mul,
                   const float* bias, void* out, long long rows, int c, long long inner,
                   float slope, cudaStream_t stream) {
  if (inner > 1) {
    const long long n = rows * c / V;
    const long long blocks = (n + STRIDED_THREADS - 1) / STRIDED_THREADS;
    norm_act_strided_elementwise_kernel<T, V, ACT, RES>
        <<<(unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID), STRIDED_THREADS, 0, stream>>>(
            (const T*)x, (const T*)res, mean, mul, bias, (T*)out, n, inner / V, c, slope);
    return cudaGetLastError();
  }
  const int vecs = c / V;
  const int rpb = vecs >= TARGET_THREADS ? 1 : TARGET_THREADS / vecs;
  const long long group = (long long)rpb * UNROLL;
  const long long blocks = (rows + group - 1) / group;
  const unsigned grid = (unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
  norm_act_elementwise_kernel<T, V, ACT, RES><<<grid, rpb * vecs, 0, stream>>>(
      (const T*)x, (const T*)res, mean, mul, bias, (T*)out, rows, c, rpb, slope);
  return cudaGetLastError();
}

// a residual comes only with relu (the bottleneck's tail)
template <typename T, int V>
cudaError_t dispatch(const void* x, const void* res, const float* mean, const float* mul,
                     const float* bias, void* out, long long rows, int c, long long inner,
                     int act, float slope, cudaStream_t s) {
  if (res) return launch<T, V, kRelu, true>(x, res, mean, mul, bias, out, rows, c, inner, slope, s);
  if (act == kRelu)
    return launch<T, V, kRelu, false>(x, res, mean, mul, bias, out, rows, c, inner, slope, s);
  if (act == kLeaky)
    return launch<T, V, kLeaky, false>(x, res, mean, mul, bias, out, rows, c, inner, slope, s);
  return launch<T, V, kNone, false>(x, res, mean, mul, bias, out, rows, c, inner, slope, s);
}

}  // namespace

// x, res (NULL: none) and out: rows x c elements filling one span of memory
// each, laid out alike, float32 (dtype 0) or bfloat16 (dtype 1), with the
// channel axis at stride inner (1: channels innermost, rows of c); mean, mul,
// bias: c float32 each.  act: 0 none, 1 relu, 2 leaky (slope: the leaky
// ReLU's slope in float); a residual only with relu.  Channels innermost: at
// most 1024 vectors of channels a row (c <= 8192 bf16 or 4096 f32 when c is a
// multiple of the 16-byte vector, else c <= 1024).
// Returns the cudaError_t of the launch (0 on success); an empty map
// launches nothing.
extern "C" int norm_act(const void* x, const void* res, const void* mean, const void* mul,
                        const void* bias, void* out, long long rows, int c, long long inner,
                        int dtype, int act, float slope, void* stream) {
  if (c <= 0 || rows < 0 || inner < 1 || dtype < 0 || dtype > 1 || act < kNone ||
      act > kLeaky || (res && act != kRelu))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int width = dtype == 1 ? 8 : 4;  // elements in 16 bytes
  const bool aligned = ((uintptr_t)x | (uintptr_t)res | (uintptr_t)out) % 16 == 0;
  const bool vec = (inner == 1 ? c : inner) % width == 0 && aligned;
  if (inner == 1 && (vec ? c / width : c) > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const float* m = (const float*)mean;
  const float* s = (const float*)mul;
  const float* b = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)(vec ? dispatch<__nv_bfloat16, 8>(x, res, m, s, b, out, rows, c, inner, act,
                                                  slope, st)
                     : dispatch<__nv_bfloat16, 1>(x, res, m, s, b, out, rows, c, inner, act,
                                                  slope, st));
  return (int)(vec ? dispatch<float, 4>(x, res, m, s, b, out, rows, c, inner, act, slope, st)
                   : dispatch<float, 1>(x, res, m, s, b, out, rows, c, inner, act, slope, st));
}
