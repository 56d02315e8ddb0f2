// Flat-band GroupNorm forward for ragged maps (G does not divide H*W).
//
// Replaces: band_groupnorm_pallas, masklab_tpu/ops/pallas/groupnorm_kernel.py
// (pallas_call at :141), the TPU kernel behind nn/layers.py GroupNorm's
// ragged branch.
//
// What it computes: x is [N, Q, C] (Q = H*W, channels minor). Flattened per
// sample, the map is Q*C elements; band g is the contiguous run
// [g*L, (g+1)*L) with L = Q*C/G. Statistics are f32 E[x] and E[x^2] over the
// band, inv = rsqrt(max(m2 - m1^2, 0) + eps), and the affine is periodic along
// the band: element p of band g uses scale[g*cg + p % cg], cg = C/G (the
// reference's per-(band, c mod C/G) affine). fuse_relu applies relu to the
// input first. Output is stored in the input type (f32 or bf16), rounded once.
//
// Bound on an H100 SXM: bytes. At the mask-head shape [1600, 196, 128] bf16
// the op must read 80.3 MB and write 80.3 MB: 160.6 MB / 3.35 TB/s = 48 us.
// It does about 8 f32 operations per element (321 MFLOP, ~5 us at 67 TFLOP/s).
// A band is small (3 KB at that shape), so what keeps the card from the byte
// bound is latency: a band's statistics must be complete before any of its
// outputs can be written, and every byte in flight waits on that reduction.
//
// Design (the warp path, taken when the band is 16-byte vectors, cg is a
// power of two dividing 32 vectors' worth of elements, and the band fits in
// 16 vectors per lane: every map of the mask heads):
// - One warp per band, held in registers. Each lane loads its vectors once
//   (7 x 16 B per lane at the main shape), the moments reduce with warp
//   shuffles alone (no shared memory, no block barrier), and the normalized
//   vectors are stored from the same registers: one read and one write of
//   each byte of device memory.
// - Persistent blocks sized by the occupancy calculator; each warp walks
//   bands w, w + W, w + 2W, ... with two register buffers in ping-pong: the
//   next band's loads are issued before the current band is reduced, so a
//   warp keeps up to two bands in flight and the reduction's latency hides
//   behind the next band's loads. Registers were chosen over cp.async or a
//   1-D bulk (TMA) copy because the data is consumed once, by the lane that
//   loads it: staging it through shared memory adds a write and a read of
//   shared memory and an mbarrier wait per band, and buys nothing that the
//   second register buffer does not.
// - The periodic affine is hoisted out of the element loop: with cg a power
//   of two dividing 32 * V (V elements per vector), lane l's element k of
//   every vector it holds has phase (V*l + k) % cg, so the lane loads its V
//   scale and bias values once per band and the element loop does no `%`
//   and no loads.
// Every other map (another cg, a length that is not whole vectors, an
// unaligned pointer, a band longer than 16 vectors per lane) takes the block
// path: one 256-thread block per band, a strided pass for the moments, a
// block reduction and a second pass over the band (served from L1/L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // block path: threads per band
constexpr int kWarpThreads = 256;   // warp path: 8 warps per block
constexpr int kMaxLaneVectors = 16; // warp path: vectors a lane holds at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// elements per 16-byte vector
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[Vec<T>::n]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) v[k] = to_f32(e[k]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[Vec<T>::n]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) from_f32(v[k], &e[k]);
  return raw;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[Vec<T>::n]) {
  unpack<T>(*reinterpret_cast<const uint4*>(p), v);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[Vec<T>::n]) {
  *reinterpret_cast<uint4*>(p) = pack<T>(v);
}

__device__ __forceinline__ float2 warp_sum2(float a, float b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  const float2 w = warp_sum2(a, b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { sa[warp] = w.x; sb[warp] = w.y; }
  __syncthreads();
  a = lane < kThreads / 32 ? sa[lane] : 0.f;
  b = lane < kThreads / 32 ? sb[lane] : 0.f;
  return warp_sum2(a, b);
}

// ---- warp path ----

// Lane `lane` loads vectors lane, lane + 32, ... of band `band`.
template <typename T, int NV>
__device__ __forceinline__ void load_band(const T* __restrict__ x, int band,
                                          int length, int lane,
                                          uint4 (&buf)[NV]) {
  constexpr int V = Vec<T>::n;
  const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)band * length);
  const int nvec = length / V;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int v = lane + 32 * t;
    if (v < nvec) buf[t] = xb[v];
  }
}

template <typename T, bool kRelu, int NV>
__device__ __forceinline__ void norm_band(
    const uint4 (&buf)[NV], const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ y, int band, int length,
    int groups, int cg, float eps, int lane) {
  constexpr int V = Vec<T>::n;
  const int nvec = length / V;
  const int g = band % groups;
  float sc[V], bi[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ph = g * cg + (V * lane + k) % cg;
    sc[k] = scale[ph];
    bi[k] = bias[ph];
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    if (lane + 32 * t < nvec) {
      float v[V];
      unpack<T>(buf[t], v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = kRelu ? fmaxf(v[k], 0.f) : v[k];
        s1 += f;
        s2 += f * f;
      }
    }
  }
  const float2 s = warp_sum2(s1, s2);
  const float m1 = s.x / (float)length;
  const float m2 = s.y / (float)length;
  const float inv = rsqrtf(fmaxf(m2 - m1 * m1, 0.f) + eps);
  uint4* yb = reinterpret_cast<uint4*>(y + (size_t)band * length);
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int v = lane + 32 * t;
    if (v < nvec) {
      float e[V];
      unpack<T>(buf[t], e);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = kRelu ? fmaxf(e[k], 0.f) : e[k];
        e[k] = (f - m1) * inv * sc[k] + bi[k];
      }
      yb[v] = pack<T>(e);
    }
  }
}

template <typename T, bool kRelu, int NV>
__global__ void __launch_bounds__(kWarpThreads)
band_groupnorm_warp_kernel(const T* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, T* __restrict__ y,
                           int bands, int length, int groups, int cg,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (kWarpThreads / 32);
  int band = blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  uint4 a[NV], b[NV];
  if (band < bands) load_band<T, NV>(x, band, length, lane, a);
  // ping-pong: a holds `band`, b the next one, loaded before a is reduced
  while (band < bands) {
    const int next = band + stride;
    if (next < bands) load_band<T, NV>(x, next, length, lane, b);
    norm_band<T, kRelu, NV>(a, scale, bias, y, band, length, groups, cg, eps, lane);
    if (next >= bands) break;
    const int after = next + stride;
    if (after < bands) load_band<T, NV>(x, after, length, lane, a);
    norm_band<T, kRelu, NV>(b, scale, bias, y, next, length, groups, cg, eps, lane);
    band = after;
  }
}

template <typename T, bool kRelu, int NV>
cudaError_t launch_warp(const void* x, const void* scale, const void* bias,
                        void* y, int bands, int length, int groups, int cg,
                        float eps, cudaStream_t stream) {
  static int per_sm = 0;   // resident blocks per SM, from the occupancy calculator
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, band_groupnorm_warp_kernel<T, kRelu, NV>, kWarpThreads, 0);
    if (e != cudaSuccess) return e;
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int warps = kWarpThreads / 32;
  const long long needed = ((long long)bands + warps - 1) / warps;
  const int grid = (int)(needed < (long long)sms * per_sm ? needed : (long long)sms * per_sm);
  band_groupnorm_warp_kernel<T, kRelu, NV><<<grid, kWarpThreads, 0, stream>>>(
      (const T*)x, (const float*)scale, (const float*)bias, (T*)y, bands,
      length, groups, cg, eps);
  return cudaSuccess;
}

// ---- block path ----

template <typename T, bool kRelu, bool kVec>
__global__ void __launch_bounds__(kThreads)
band_groupnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int length, int groups, int cg, float eps) {
  constexpr int V = Vec<T>::n;
  const int band = blockIdx.x;                 // n * groups + g
  const int g = band % groups;
  const T* xb = x + (size_t)band * length;
  T* yb = y + (size_t)band * length;
  const float* sc = scale + g * cg;
  const float* bi = bias + g * cg;

  float s1 = 0.f, s2 = 0.f;
  if (kVec) {
    for (int p = threadIdx.x * V; p < length; p += kThreads * V) {
      float v[V];
      load_vec(xb + p, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = kRelu ? fmaxf(v[k], 0.f) : v[k];
        s1 += f;
        s2 += f * f;
      }
    }
  } else {
    for (int p = threadIdx.x; p < length; p += kThreads) {
      float f = to_f32(xb[p]);
      if (kRelu) f = fmaxf(f, 0.f);
      s1 += f;
      s2 += f * f;
    }
  }
  const float2 s = block_sum2(s1, s2);
  const float m1 = s.x / (float)length;
  const float m2 = s.y / (float)length;
  const float inv = rsqrtf(fmaxf(m2 - m1 * m1, 0.f) + eps);

  if (kVec) {
    for (int p = threadIdx.x * V; p < length; p += kThreads * V) {
      float v[V];
      load_vec(xb + p, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = kRelu ? fmaxf(v[k], 0.f) : v[k];
        const int ph = (p + k) % cg;
        v[k] = (f - m1) * inv * sc[ph] + bi[ph];
      }
      store_vec(yb + p, v);
    }
  } else {
    for (int p = threadIdx.x; p < length; p += kThreads) {
      float f = to_f32(xb[p]);
      if (kRelu) f = fmaxf(f, 0.f);
      const int ph = p % cg;
      from_f32((f - m1) * inv * sc[ph] + bi[ph], &yb[p]);
    }
  }
}

template <typename T, bool kRelu>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   int n, int length, int groups, int cg, float eps,
                   cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int bands = n * groups;
  const bool vec = (length % V == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const bool periodic = (cg & (cg - 1)) == 0 && (32 * V) % cg == 0;
  const int lane_vectors = (length / V + 31) / 32;
  if (vec && periodic && lane_vectors <= kMaxLaneVectors) {
    if (lane_vectors <= 8)
      return launch_warp<T, kRelu, 8>(x, scale, bias, y, bands, length, groups,
                                      cg, eps, stream);
    return launch_warp<T, kRelu, kMaxLaneVectors>(x, scale, bias, y, bands,
                                                  length, groups, cg, eps, stream);
  }
  if (vec) {
    band_groupnorm_kernel<T, kRelu, true><<<bands, kThreads, 0, stream>>>(
        (const T*)x, (const float*)scale, (const float*)bias, (T*)y, length,
        groups, cg, eps);
  } else {
    band_groupnorm_kernel<T, kRelu, false><<<bands, kThreads, 0, stream>>>(
        (const T*)x, (const float*)scale, (const float*)bias, (T*)y, length,
        groups, cg, eps);
  }
  return cudaSuccess;
}

}  // namespace

// Name of a CUDA error code returned by any of the library's entry points.
extern "C" const char* mlk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// x, y: [n, q, c] contiguous, dtype 0 = float32, 1 = bfloat16.
// scale, bias: [c] float32. Returns the first CUDA error of the launch.
extern "C" int mlk_band_groupnorm(const void* x, const void* scale,
                                  const void* bias, void* y, int n, int q,
                                  int c, int groups, float eps, int fuse_relu,
                                  int dtype, void* stream) {
  const int length = q * (c / groups);
  const int cg = c / groups;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (n > 0 && length > 0) {
    if (dtype == 0) {
      e = fuse_relu ? launch<float, true>(x, scale, bias, y, n, length, groups, cg, eps, st)
                    : launch<float, false>(x, scale, bias, y, n, length, groups, cg, eps, st);
    } else {
      e = fuse_relu ? launch<__nv_bfloat16, true>(x, scale, bias, y, n, length, groups, cg, eps, st)
                    : launch<__nv_bfloat16, false>(x, scale, bias, y, n, length, groups, cg, eps, st);
    }
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
