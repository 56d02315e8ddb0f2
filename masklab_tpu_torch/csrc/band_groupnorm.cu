// Flat-band GroupNorm for ragged maps (G does not divide H*W): the forward,
// and below it the backward.
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

// Blocks of `kernel` (kWarpThreads threads, no dynamic shared memory)
// resident at once on the current device. `per_sm`, the caller's cache of
// the occupancy calculator's blocks per SM, is filled on the first call.
template <class K>
cudaError_t resident_blocks(K kernel, int& per_sm, long long* blocks) {
  cudaError_t e = cudaSuccess;
  if (per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarpThreads, 0);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = (long long)sms * per_sm;
  return e;
}

template <typename T, bool kRelu, int NV>
cudaError_t launch_warp(const void* x, const void* scale, const void* bias,
                        void* y, int bands, int length, int groups, int cg,
                        float eps, cudaStream_t stream) {
  static int per_sm = 0;
  long long resident = 0;
  const cudaError_t e = resident_blocks(
      band_groupnorm_warp_kernel<T, kRelu, NV>, per_sm, &resident);
  if (e != cudaSuccess) return e;
  const int warps = kWarpThreads / 32;
  const long long needed = ((long long)bands + warps - 1) / warps;
  const int grid = (int)(needed < resident ? needed : resident);
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

// ---- backward ----
//
// Replaces: _bgn_bwd, masklab_tpu/ops/pallas/groupnorm_kernel.py:208, the
// custom_vjp backward of band_groupnorm (XLA beside the Pallas forward).
//
// What it computes, per band of L elements (f = relu(x) when fuse_relu, else
// x; s_e the periodic scale of each element): m1, inv as in the forward,
// x^ = (f - m1) * inv, g = dy * s_e, and
//   dx = inv * (g - mean(g) - x^ * mean(g * x^))      (times [x > 0] with relu)
//   dscale[g*cg + j] = sum of dy * x^, dbias[g*cg + j] = sum of dy
// over every element of band g (all samples) whose phase p % cg is j.
// Statistics and gradients are f32; dx is rounded once to x's type.
//
// Bound on an H100 SXM: bytes. At the train path's mask-head shape
// [432, 196, 128] bf16 the op must read x and dy and write dx: 65 MB /
// 3.35 TB/s = 19 us; ~20 f32 operations per element are ~3 us.
//
// Both paths: one pass over each band computes sum f, sum f^2, sum g and
// sum g*f, from which sum g*x^ = inv * (sum g*f - m1 * sum g); a second
// pass writes dx and keeps dy*x^ and dy per phase. No float atomics
// anywhere, and every sum is taken in an order fixed by the shapes and the
// card, so every run gives the same bits.
// - Warp path (the forward's conditions: the band is whole 16-byte vectors,
//   aligned, cg a power of two dividing 32 vectors' worth of elements, and
//   at most 8 vectors per lane; every map the train path sends to the
//   backward): ONE launch per call, persistent, as the forward's warp path.
//   - Grid: blocks per group R from the occupancy calculator (the resident
//     blocks over G, at most one warp per sample), R * G blocks. Block b
//     serves group g = b % G; its 8 warps walk samples (b / G) * 8 + w,
//     stepping by 8R, so a warp meets one group only and keeps its phase
//     partials (dy*x^ and dy per element slot) in registers for its whole
//     walk.
//   - Overlap: two register buffers of x and dy in ping-pong, as in the
//     forward: the next band's loads are in flight before the current band
//     is reduced and written, so each warp keeps up to two bands (12.5 KB
//     at the main shape) in flight. This costs ~210 registers (bf16), so
//     one block of 8 warps per SM. A ring of two shared-memory stages per
//     warp filled by 1-D bulk copies (TMA, an mbarrier per stage) fits in
//     128 registers and 2 blocks per SM, but timed against this design in
//     one run it was 2-3% faster at [432, 196, 128] and 4-8% slower at the
//     smaller maps a train step sends (the barrier's setup and the copy's
//     start lie on the path of a walk of one or two bands): slower per
//     train step in sum, so registers, as in the forward.
//   - Each lane loads its vectors of x and dy once, the four sums reduce
//     with warp shuffles, dx is computed from the same registers (one read
//     of each input byte, one write of dx), and element k of every vector
//     a lane holds has phase (V*lane + k) % cg.
//   - Reduction over N, in the same launch: at the end of the walk each
//     warp folds its partials within the lane and across the lanes that
//     share phases (shuffles in a fixed order), the block adds its 8 warps
//     in order in shared memory and writes one row of cg pairs: 2 * R * C
//     floats of scratch (R = 8 on the H100 at 1 block per SM and G = 16,
//     where partials per band would take 2 * N * C).
//     Each block then takes a ticket (an integer atomic after a
//     __threadfence); the last block adds the R rows of every channel in
//     row order and resets the ticket for the next call. With R = 1 (at
//     most 8 samples) the row is the gradient: no scratch, no ticket.
// - Scalar path (any other map the forward takes, e.g. cg = 3 or a band
//   too long for registers): one block per band, read as Q rows of cg
//   elements; threads are laid out as rows x columns so that each thread
//   keeps one column (one phase) and consecutive threads read consecutive
//   elements; the second pass re-reads the band (from L1/L2); columns are
//   summed over the rows in shared memory, in order; each band's [cg]
//   partials go to scratch (2 * N * C floats) and a second kernel adds them
//   over the N samples in a fixed order.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kWarpThreads / 32;  // warp path: warps per block
constexpr int kBwdLaneVectors = 8;   // warp path: vectors a lane holds at most
constexpr int kMaxPhases = 256;      // warp path: cg at most (32 x 8 bf16)
constexpr int kReduceCols = 32;      // reduce kernel: channels per block
constexpr int kReduceRows = 8;       // reduce kernel: sample lanes per channel

__device__ __forceinline__ float4 warp_sum4(float a, float b, float c, float d) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
    c += __shfl_xor_sync(0xffffffffu, c, o);
    d += __shfl_xor_sync(0xffffffffu, d, o);
  }
  return make_float4(a, b, c, d);
}

__device__ __forceinline__ float4 block_sum4(float a, float b, float c, float d) {
  __shared__ float s[4][kBwdThreads / 32];
  const float4 w = warp_sum4(a, b, c, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s[0][warp] = w.x; s[1][warp] = w.y; s[2][warp] = w.z; s[3][warp] = w.w; }
  __syncthreads();
  // every warp reduces the warp sums in the same order: all threads agree
  return warp_sum4(lane < kBwdThreads / 32 ? s[0][lane] : 0.f,
                   lane < kBwdThreads / 32 ? s[1][lane] : 0.f,
                   lane < kBwdThreads / 32 ? s[2][lane] : 0.f,
                   lane < kBwdThreads / 32 ? s[3][lane] : 0.f);
}

// The band's constants from its four sums.
struct BandGrad {
  float m1, inv, mean_g, mean_gx;
  __device__ BandGrad(float4 s, int length, float eps) {
    m1 = s.x / (float)length;
    const float m2 = s.y / (float)length;
    inv = rsqrtf(fmaxf(m2 - m1 * m1, 0.f) + eps);
    mean_g = s.z / (float)length;
    mean_gx = inv * (s.w - m1 * s.z) / (float)length;
  }
};

// One band of the warp path from registers: dx written, the band's dy * x^
// and dy added to the lane's per-slot partials.
template <typename T, bool kRelu, int NV>
__device__ __forceinline__ void grad_band(
    const uint4 (&xr)[NV], const uint4 (&dr)[NV],
    const float (&sc)[Vec<T>::n], T* __restrict__ dx, int band, int length,
    float eps, int lane, float (&as)[Vec<T>::n], float (&ab)[Vec<T>::n]) {
  constexpr int V = Vec<T>::n;
  const int nvec = length / V;
  float s1 = 0.f, s2 = 0.f, sg = 0.f, sgf = 0.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    if (lane + 32 * t < nvec) {
      float xv[V], dv[V];
      unpack<T>(xr[t], xv);
      unpack<T>(dr[t], dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = kRelu ? fmaxf(xv[k], 0.f) : xv[k];
        const float gg = dv[k] * sc[k];
        s1 += f;
        s2 += f * f;
        sg += gg;
        sgf += gg * f;
      }
    }
  }
  const BandGrad c(warp_sum4(s1, s2, sg, sgf), length, eps);
  uint4* ob = reinterpret_cast<uint4*>(dx + (size_t)band * length);
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int v = lane + 32 * t;
    if (v < nvec) {
      float xv[V], dv[V], out[V];
      unpack<T>(xr[t], xv);
      unpack<T>(dr[t], dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = kRelu ? fmaxf(xv[k], 0.f) : xv[k];
        const float xh = (f - c.m1) * c.inv;
        const float d = c.inv * (dv[k] * sc[k] - c.mean_g - xh * c.mean_gx);
        out[k] = (!kRelu || xv[k] > 0.f) ? d : 0.f;
        as[k] += dv[k] * xh;
        ab[k] += dv[k];
      }
      ob[v] = pack<T>(out);
    }
  }
}

// part: [2][rows][c] scratch (rows = gridDim.x / groups); ticket: 0 on
// entry, left 0 on exit.
template <typename T, bool kRelu>
__global__ void __launch_bounds__(kWarpThreads, 1)
band_groupnorm_bwd_warp_kernel(const T* __restrict__ x,
                               const T* __restrict__ dy,
                               const float* __restrict__ scale,
                               T* __restrict__ dx, float* __restrict__ part,
                               float* __restrict__ dscale,
                               float* __restrict__ dbias,
                               unsigned int* __restrict__ ticket, int n,
                               int length, int groups, int cg, float eps) {
  constexpr int V = Vec<T>::n;
  constexpr int NV = kBwdLaneVectors;
  __shared__ float red[2][kBwdWarps][kMaxPhases];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x % groups, row = blockIdx.x / groups;
  const int rows = gridDim.x / groups;
  const int stride = rows * kBwdWarps;     // samples a group walks at once
  float sc[V], as[V], ab[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sc[k] = scale[g * cg + ((V * lane + k) & (cg - 1))];
    as[k] = ab[k] = 0.f;
  }
  // ping-pong: (xa, da) hold sample s, (xb, db) the next one, loaded before
  // s is reduced
  uint4 xa[NV], da[NV], xb[NV], db[NV];
  int s = row * kBwdWarps + warp;
  if (s < n) {
    load_band<T, NV>(x, s * groups + g, length, lane, xa);
    load_band<T, NV>(dy, s * groups + g, length, lane, da);
  }
  while (s < n) {
    const int next = s + stride;
    if (next < n) {
      load_band<T, NV>(x, next * groups + g, length, lane, xb);
      load_band<T, NV>(dy, next * groups + g, length, lane, db);
    }
    grad_band<T, kRelu, NV>(xa, da, sc, dx, s * groups + g, length, eps, lane, as, ab);
    if (next >= n) break;
    const int after = next + stride;
    if (after < n) {
      load_band<T, NV>(x, after * groups + g, length, lane, xa);
      load_band<T, NV>(dy, after * groups + g, length, lane, da);
    }
    grad_band<T, kRelu, NV>(xb, db, sc, dx, next * groups + g, length, eps, lane, as, ab);
    s = after;
  }
  // fold the phases within the lane (cg < V: elements k and k + cg share a
  // phase) by halves, every index a constant so that the partials stay in
  // registers; then across lanes: lanes l and l' share phases when l = l'
  // mod (cg / V), so offsets from cg / V up reduce them
#pragma unroll
  for (int h = V / 2; h >= 1; h >>= 1) {
    if (h >= cg) {
#pragma unroll
      for (int k = 0; k < h; ++k) {
        as[k] += as[k + h];
        ab[k] += ab[k + h];
      }
    }
  }
  const int first = cg > V ? cg / V : 1;
  for (int o = 16; o >= first; o >>= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      as[k] += __shfl_xor_sync(0xffffffffu, as[k], o);
      ab[k] += __shfl_xor_sync(0xffffffffu, ab[k], o);
    }
  }
  if (lane < first) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k < cg) {
        red[0][warp][V * lane + k] = as[k];
        red[1][warp][V * lane + k] = ab[k];
      }
    }
  }
  __syncthreads();
  // the block's row: its warps added in order; with one block per group
  // the row is the gradient itself
  const int c = groups * cg;
  for (int t = threadIdx.x; t < 2 * cg; t += kWarpThreads) {
    const int q = t / cg, j = t - q * cg;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) a += red[q][w][j];
    if (rows == 1)
      (q == 0 ? dscale : dbias)[g * cg + j] = a;
    else
      part[((size_t)q * rows + row) * c + g * cg + j] = a;
  }
  if (rows == 1) return;
  // the last block to finish adds the rows of every channel, in row order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int u = threadIdx.x; u < 2 * c; u += kWarpThreads) {
    const int q = u / c, ch = u - q * c;
    const float* col = part + (size_t)q * rows * c + ch;
    float a = 0.f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) a += __ldcg(col + (size_t)r * c);
    (q == 0 ? dscale : dbias)[ch] = a;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kBwdThreads)
band_groupnorm_bwd_scalar_kernel(const T* __restrict__ x,
                                 const T* __restrict__ dy,
                                 const float* __restrict__ scale,
                                 T* __restrict__ dx, float* __restrict__ part_s,
                                 float* __restrict__ part_b, int q, int groups,
                                 int cg, float eps) {
  __shared__ float sh_s[kBwdThreads], sh_b[kBwdThreads];
  const int band = blockIdx.x, g = band % groups, t = threadIdx.x;
  const int length = q * cg;
  const T* xb = x + (size_t)band * length;
  const T* db = dy + (size_t)band * length;
  T* ob = dx + (size_t)band * length;
  // the band as [q, cg]: `rows` rows side by side, `cols` columns per row
  const int rows = cg >= kBwdThreads ? 1 : kBwdThreads / cg;
  const int cols = cg >= kBwdThreads ? kBwdThreads : cg;
  const bool active = t < rows * cols;
  const int r0 = t / cols, j0 = t % cols;

  float s1 = 0.f, s2 = 0.f, sg = 0.f, sgf = 0.f;
  if (active) {
    for (int j = j0; j < cg; j += cols) {
      const float sc = scale[g * cg + j];
      for (int r = r0; r < q; r += rows) {
        float f = to_f32(xb[(size_t)r * cg + j]);
        if (kRelu) f = fmaxf(f, 0.f);
        const float gg = to_f32(db[(size_t)r * cg + j]) * sc;
        s1 += f;
        s2 += f * f;
        sg += gg;
        sgf += gg * f;
      }
    }
  }
  const BandGrad c(block_sum4(s1, s2, sg, sgf), length, eps);

  float as = 0.f, ab = 0.f;
  if (active) {
    for (int j = j0; j < cg; j += cols) {
      const float sc = scale[g * cg + j];
      as = ab = 0.f;
      for (int r = r0; r < q; r += rows) {
        const size_t p = (size_t)r * cg + j;
        const float xv = to_f32(xb[p]);
        const float f = kRelu ? fmaxf(xv, 0.f) : xv;
        const float dv = to_f32(db[p]);
        const float xh = (f - c.m1) * c.inv;
        const float d = c.inv * (dv * sc - c.mean_g - xh * c.mean_gx);
        from_f32((!kRelu || xv > 0.f) ? d : 0.f, &ob[p]);
        as += dv * xh;
        ab += dv;
      }
      if (rows == 1) {      // this thread saw all of column j
        part_s[(size_t)band * cg + j] = as;
        part_b[(size_t)band * cg + j] = ab;
      }
    }
  }
  if (rows > 1) {           // each active thread held one column: sum its rows
    sh_s[t] = active ? as : 0.f;
    sh_b[t] = active ? ab : 0.f;
    __syncthreads();
    if (t < cg) {
      float a = 0.f, b = 0.f;
      for (int i = 0; i < rows; ++i) {
        a += sh_s[i * cols + t];
        b += sh_b[i * cols + t];
      }
      part_s[(size_t)band * cg + t] = a;
      part_b[(size_t)band * cg + t] = b;
    }
  }
}

// dscale[ch] = sum over n of part_s[n, ch] (likewise dbias), in a fixed
// order: lane y of a channel adds samples y, y + 8, ...; the 8 lanes are then
// added in order.
__global__ void __launch_bounds__(kReduceCols * kReduceRows)
band_groupnorm_bwd_reduce_kernel(const float* __restrict__ part_s,
                                 const float* __restrict__ part_b,
                                 float* __restrict__ dscale,
                                 float* __restrict__ dbias, int n, int c) {
  __shared__ float sa[kReduceRows][kReduceCols], sb[kReduceRows][kReduceCols];
  const int ch = blockIdx.x * kReduceCols + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (ch < c) {
    for (int i = threadIdx.y; i < n; i += kReduceRows) {
      a += part_s[(size_t)i * c + ch];
      b += part_b[(size_t)i * c + ch];
    }
  }
  sa[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    a = b = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceRows; ++y) {
      a += sa[y][threadIdx.x];
      b += sb[y][threadIdx.x];
    }
    dscale[ch] = a;
    dbias[ch] = b;
  }
}

// The warp path's blocks per group: as many as are resident at once over
// G (at least 1), and no more than the samples need.
template <typename T, bool kRelu>
cudaError_t bwd_rows(int n, int groups, int* rows) {
  static int per_sm = 0;
  long long resident = 0;
  const cudaError_t e = resident_blocks(
      band_groupnorm_bwd_warp_kernel<T, kRelu>, per_sm, &resident);
  if (e != cudaSuccess) return e;
  const long long per_group = resident / groups;
  const long long needed = ((long long)n + kBwdWarps - 1) / kBwdWarps;
  long long r = per_group < needed ? per_group : needed;
  *rows = (int)(r < 1 ? 1 : r);
  return cudaSuccess;
}

template <typename T, bool kRelu>
cudaError_t launch_bwd(const void* x, const void* dy, const void* scale,
                       void* dx, void* dscale, void* dbias, float* part,
                       unsigned int* ticket, int n, int q, int groups, int cg,
                       float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int bands = n * groups, length = q * cg, c = groups * cg;
  const bool vec = (length % V == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dy) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dx) % 16 == 0);
  const bool pow2 = (cg & (cg - 1)) == 0;
  if (vec && pow2 && (32 * V) % cg == 0 &&
      (length / V + 31) / 32 <= kBwdLaneVectors) {
    int rows = 0;
    const cudaError_t e = bwd_rows<T, kRelu>(n, groups, &rows);
    if (e != cudaSuccess) return e;
    band_groupnorm_bwd_warp_kernel<T, kRelu>
        <<<rows * groups, kWarpThreads, 0, stream>>>(
            (const T*)x, (const T*)dy, (const float*)scale, (T*)dx, part,
            (float*)dscale, (float*)dbias, ticket, n, length, groups, cg, eps);
    return cudaGetLastError();
  }
  float* part_s = part;
  float* part_b = part + (size_t)n * c;
  band_groupnorm_bwd_scalar_kernel<T, kRelu><<<bands, kBwdThreads, 0, stream>>>(
      (const T*)x, (const T*)dy, (const float*)scale, (T*)dx, part_s, part_b,
      q, groups, cg, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 block(kReduceCols, kReduceRows);
  band_groupnorm_bwd_reduce_kernel<<<(c + kReduceCols - 1) / kReduceCols, block, 0, stream>>>(
      part_s, part_b, (float*)dscale, (float*)dbias, n, c);
  return cudaGetLastError();
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

// The backward of mlk_band_groupnorm. x, dy, dx: [n, q, c] contiguous, dtype
// 0 = float32, 1 = bfloat16; scale: [c] float32; dscale, dbias: [c] float32
// outputs; partials: float32 scratch of 2 * n * c (the warp path uses
// 2 * R * c of it, R <= ceil(n / 8)); ticket: one unsigned int, 0 before
// the first call, which each call leaves at 0 (calls that share a ticket
// must not run concurrently).
// Returns the first CUDA error of the launches.
extern "C" int mlk_band_groupnorm_backward(const void* x, const void* dy,
                                           const void* scale, void* dx,
                                           void* dscale, void* dbias,
                                           void* partials, void* ticket,
                                           int n, int q, int c, int groups,
                                           float eps, int fuse_relu,
                                           int dtype, void* stream) {
  const int cg = c / groups;
  cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)partials;
  unsigned int* tk = (unsigned int*)ticket;
  cudaError_t e = cudaSuccess;
  if (n > 0 && q > 0 && c > 0) {
    if (dtype == 0) {
      e = fuse_relu ? launch_bwd<float, true>(x, dy, scale, dx, dscale, dbias, part, tk, n, q, groups, cg, eps, st)
                    : launch_bwd<float, false>(x, dy, scale, dx, dscale, dbias, part, tk, n, q, groups, cg, eps, st);
    } else {
      e = fuse_relu ? launch_bwd<__nv_bfloat16, true>(x, dy, scale, dx, dscale, dbias, part, tk, n, q, groups, cg, eps, st)
                    : launch_bwd<__nv_bfloat16, false>(x, dy, scale, dx, dscale, dbias, part, tk, n, q, groups, cg, eps, st);
    }
  } else if (c > 0) {      // no element: the parameter gradients are 0
    e = cudaMemsetAsync(dscale, 0, (size_t)c * sizeof(float), st);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(dbias, 0, (size_t)c * sizeof(float), st);
  }
  return (int)e;
}
