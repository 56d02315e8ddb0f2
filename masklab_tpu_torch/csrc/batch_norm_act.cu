// Eval BatchNorm and the activation after it, in one pass over the map.
//
// Replaces: no Pallas kernel. The JAX package's eval BatchNorm is flax's
// nn.BatchNorm, which XLA fuses with its neighbours; the port's plain chain
// (ops/cuda/batch_norm_act.py batch_norm_act_plain) runs one PyTorch kernel
// a step over the whole map: the cast to float32, `- mean`, `* mul`,
// `+ bias`, the cast back, then the residual add and the activation. In a
// bf16 map that is about 40 B of device traffic an element where 4 B (6 B
// with a residual) is needed.
//
// What it computes, for each element of a channels_last map x [N, H, W, C]
// (flat index i, channel i % C) or of a contiguous NCHW map (channel
// (i / (H W)) % C), in this order:
//   f = float(x); y = ((f - mean[c]) * mul[c]) + bias[c], each operation
//   rounded in float32 as PyTorch's separate kernels round it (explicit
//   round-to-nearest intrinsics; this file is also built with -fmad=false);
//   o = round_to_type(y);
//   with a residual r: o = round_to_type(float(o) + float(r));
//   relu: o < 0 ? 0 : o (a NaN stays, as clamp_min keeps it);
//   silu: v = float(o), o = round_to_type(v / (1 + expf(-v))), ATen's CUDA
//   silu formula.
// So the output is bit for bit the plain chain's on the card.
//
// Bound on an H100 SXM: bytes. Per element one read of x (and of r) and one
// write, a few float32 operations; the [C] vectors are read once a thread.
// No tensor cores or TMA apply.
//
// Design:
//  - 16-byte vectors (8 bf16 / f16, 4 f32) where C is a multiple of the
//    vector and every pointer is 16-byte aligned, a scalar element
//    otherwise;
//  - channels_last: a grid-stride loop whose stride (blocks x threads) is a
//    multiple of the vectors (elements) of a pixel, so each thread's
//    channels are fixed: it reads its mean, mul and bias into registers
//    once and streams; two vectors a thread an iteration, the next two
//    loaded before these are computed (the loads stay in flight through
//    silu's arithmetic);
//  - NCHW: a plain grid-stride loop, each unit's channel from its plane
//    (16-byte vectors where a plane holds whole vectors);
//  - 4 CTAs of 256 threads an SM, as many CTAs as fill the SMs (rounded up
//    to the channels_last stride's period).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

enum Act { kNone = 0, kRelu = 1, kSilu = 2 };

// A storage type's bits and its float conversions (round to nearest even).
template <typename T> struct Io;
template <> struct Io<float> {
  using Raw = unsigned int;
  static __device__ __forceinline__ float to_f(Raw v) { return __uint_as_float(v); }
  static __device__ __forceinline__ Raw from_f(float v) { return __float_as_uint(v); }
};
template <> struct Io<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float to_f(Raw v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ Raw from_f(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Io<__half> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float to_f(Raw v) { return __half2float(__ushort_as_half(v)); }
  static __device__ __forceinline__ Raw from_f(float v) { return __half_as_ushort(__float2half_rn(v)); }
};

template <typename T>
union Vec {
  uint4 u;
  typename Io<T>::Raw e[16 / sizeof(typename Io<T>::Raw)];
};

template <typename T, int ACT, bool RES>
__device__ __forceinline__ typename Io<T>::Raw element(typename Io<T>::Raw xv,
                                                       typename Io<T>::Raw rv,
                                                       float m, float s, float b) {
  using I = Io<T>;
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(I::to_f(xv), m), s), b);
  typename I::Raw o = I::from_f(y);
  if (RES) o = I::from_f(__fadd_rn(I::to_f(o), I::to_f(rv)));
  if (ACT == kRelu) {
    if (I::to_f(o) < 0.f) o = I::from_f(0.f);
  } else if (ACT == kSilu) {
    const float v = I::to_f(o);
    o = I::from_f(__fdiv_rn(v, __fadd_rn(1.f, expf(-v))));
  }
  return o;
}

template <typename T, int ACT, bool RES, int V>
__device__ __forceinline__ uint4 vector(uint4 xv, uint4 rv, const float* m,
                                        const float* s, const float* b) {
  Vec<T> a, r, o;
  a.u = xv;
  r.u = rv;
#pragma unroll
  for (int k = 0; k < V; ++k) o.e[k] = element<T, ACT, RES>(a.e[k], r.e[k], m[k], s[k], b[k]);
  return o.u;
}

// Vector `i` of `p`, or zeros past the end.
__device__ __forceinline__ uint4 load(const uint4* __restrict__ p, long long i, long long n) {
  return i < n ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
}

// nvec 16-byte vectors, vpp of them a pixel; gridDim.x * kThreads is a
// multiple of vpp, so a thread's vectors all hold channels
// [(t % vpp) * V, (t % vpp + 1) * V).
template <typename T, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
batch_norm_act_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ r,
                          const float* __restrict__ mean, const float* __restrict__ mul,
                          const float* __restrict__ bias, uint4* __restrict__ y,
                          long long nvec, int vpp) {
  constexpr int V = 16 / sizeof(typename Io<T>::Raw);
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nvec) return;
  const int c0 = (int)(i % vpp) * V;
  float m[V], s[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = __ldg(mean + c0 + k);
    s[k] = __ldg(mul + c0 + k);
    b[k] = __ldg(bias + c0 + k);
  }
  // Two vectors an iteration, and the next iteration's two loaded before
  // this one's are computed, so loads stay in flight through the epilogue's
  // arithmetic (silu's expf and division).
  uint4 x0 = load(x, i, nvec), x1 = load(x, i + stride, nvec);
  uint4 r0 = RES ? load(r, i, nvec) : x0, r1 = RES ? load(r, i + stride, nvec) : x1;
  while (i < nvec) {
    const long long next = i + 2 * stride;
    const uint4 nx0 = load(x, next, nvec), nx1 = load(x, next + stride, nvec);
    const uint4 nr0 = RES ? load(r, next, nvec) : nx0;
    const uint4 nr1 = RES ? load(r, next + stride, nvec) : nx1;
    y[i] = vector<T, ACT, RES, V>(x0, r0, m, s, b);
    if (i + stride < nvec) y[i + stride] = vector<T, ACT, RES, V>(x1, r1, m, s, b);
    x0 = nx0;
    x1 = nx1;
    r0 = nr0;
    r1 = nr1;
    i = next;
  }
}

// n elements of c channels; gridDim.x * kThreads is a multiple of c.
template <typename T, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads)
batch_norm_act_scalar_kernel(const typename Io<T>::Raw* __restrict__ x,
                             const typename Io<T>::Raw* __restrict__ r,
                             const float* __restrict__ mean, const float* __restrict__ mul,
                             const float* __restrict__ bias, typename Io<T>::Raw* __restrict__ y,
                             long long n, int c) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int ch = (int)(i % c);
  const float m = __ldg(mean + ch), s = __ldg(mul + ch), b = __ldg(bias + ch);
  for (; i < n; i += stride) y[i] = element<T, ACT, RES>(x[i], RES ? r[i] : 0, m, s, b);
}

// A contiguous NCHW map: units of V elements (one element, or a 16-byte
// vector where a plane's elements hold whole vectors), upp units a plane,
// the planes in (n, c) order.
template <typename T, int ACT, bool RES, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_act_planar_kernel(const void* __restrict__ xp, const void* __restrict__ rp,
                             const float* __restrict__ mean, const float* __restrict__ mul,
                             const float* __restrict__ bias, void* __restrict__ yp,
                             long long units, long long upp, int c) {
  using Raw = typename Io<T>::Raw;
  using Unit = typename std::conditional<V == 1, Raw, uint4>::type;
  const Unit* __restrict__ x = (const Unit*)xp;
  const Unit* __restrict__ r = (const Unit*)rp;
  Unit* __restrict__ y = (Unit*)yp;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < units; i += stride) {
    const int ch = (int)((i / upp) % c);
    const float m = __ldg(mean + ch), s = __ldg(mul + ch), b = __ldg(bias + ch);
    if constexpr (V == 1) {
      y[i] = element<T, ACT, RES>(x[i], RES ? r[i] : (Raw)0, m, s, b);
    } else {
      float mv[V], sv[V], bv[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        mv[k] = m;
        sv[k] = s;
        bv[k] = b;
      }
      const uint4 xv = __ldg(x + i);
      y[i] = vector<T, ACT, RES, V>(xv, RES ? __ldg(r + i) : xv, mv, sv, bv);
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && counts[dev]) return counts[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    sms = 1;
  if (dev < kMaxDevices) counts[dev] = sms;
  return sms;
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// CTAs for `units` work items whose channels repeat every `period` items:
// enough to fill the SMs (or to give each thread one item), rounded up so
// that the grid's threads are a multiple of the period.
unsigned blocks_for(long long units, int period) {
  const long long fill = (long long)sm_count() * kBlocksPerSm;
  long long want = (units + kThreads - 1) / kThreads;
  if (want > fill) want = fill;
  const long long every = period / gcd(period, kThreads);
  return (unsigned)((want + every - 1) / every * every);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int ACT, bool RES>
cudaError_t launch_act(const void* x, const void* r, const float* mean, const float* mul,
                       const float* bias, void* y, long long n, int c, long long hw,
                       cudaStream_t st) {
  using Raw = typename Io<T>::Raw;
  constexpr int V = 16 / sizeof(Raw);
  const bool aligned = aligned16(x) && aligned16(y) && (!RES || aligned16(r));
  if (hw > 0) {
    if (hw % V == 0 && aligned) {
      batch_norm_act_planar_kernel<T, ACT, RES, V><<<blocks_for(n / V, 1), kThreads, 0, st>>>(
          x, r, mean, mul, bias, y, n / V, hw / V, c);
    } else {
      batch_norm_act_planar_kernel<T, ACT, RES, 1><<<blocks_for(n, 1), kThreads, 0, st>>>(
          x, r, mean, mul, bias, y, n, hw, c);
    }
  } else if (c % V == 0 && aligned) {
    const long long nvec = n / V;
    const int vpp = c / V;
    batch_norm_act_vec_kernel<T, ACT, RES><<<blocks_for(nvec, vpp), kThreads, 0, st>>>(
        (const uint4*)x, (const uint4*)r, mean, mul, bias, (uint4*)y, nvec, vpp);
  } else {
    batch_norm_act_scalar_kernel<T, ACT, RES><<<blocks_for(n, c), kThreads, 0, st>>>(
        (const Raw*)x, (const Raw*)r, mean, mul, bias, (Raw*)y, n, c);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const float* mean, const float* mul,
                   const float* bias, void* y, long long n, int c, long long hw, int act,
                   cudaStream_t st) {
  if (r != nullptr) {
    if (act == kRelu) return launch_act<T, kRelu, true>(x, r, mean, mul, bias, y, n, c, hw, st);
    if (act == kSilu) return launch_act<T, kSilu, true>(x, r, mean, mul, bias, y, n, c, hw, st);
    return launch_act<T, kNone, true>(x, r, mean, mul, bias, y, n, c, hw, st);
  }
  if (act == kRelu) return launch_act<T, kRelu, false>(x, r, mean, mul, bias, y, n, c, hw, st);
  if (act == kSilu) return launch_act<T, kSilu, false>(x, r, mean, mul, bias, y, n, c, hw, st);
  return launch_act<T, kNone, false>(x, r, mean, mul, bias, y, n, c, hw, st);
}

}  // namespace

// x, y (and r, or null): n elements of a map of c channels, channels_last
// where hw is 0, else contiguous NCHW with hw = H * W elements a plane;
// dtype 0 = float32, 1 = bfloat16, 2 = float16; mean, mul, bias: [c]
// float32; act 0 = none, 1 = relu, 2 = silu. One launch on `stream`;
// returns the first CUDA error of the launch.
extern "C" int mlk_batch_norm_act(const void* x, const void* r, const void* mean,
                                  const void* mul, const void* bias, void* y,
                                  long long n, int c, long long hw, int dtype, int act,
                                  void* stream) {
  if (n <= 0 || c <= 0) return 0;
  const float* m = (const float*)mean;
  const float* s = (const float*)mul;
  const float* b = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(x, r, m, s, b, y, n, c, hw, act, st);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(x, r, m, s, b, y, n, c, hw, act, st);
  } else {
    e = launch<__half>(x, r, m, s, b, y, n, c, hw, act, st);
  }
  return (int)e;
}
