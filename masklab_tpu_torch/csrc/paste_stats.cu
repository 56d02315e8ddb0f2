// Thresholded statistics of the full-frame mask paste, over each kept box's
// own pixels.
//
// Replaces: no Pallas kernel. The JAX package reduces the pasted
// [B, K, H, W] tensor in XLA (masklab_tpu/serving/postprocess.py
// paste_stats_and_union, :138-200); the port's plain version
// (ops/cuda/paste_stats.py paste_reduce_plain) forms that tensor with two
// f32 GEMMs, `full = wx @ (wy @ mask)^T`, then thresholds and sums it.
// At b16 x 100 boxes x 1080x1920 that tensor is 13.3 GB, written and read
// about ten times, although a box's paste is zero outside its clipped
// rectangle and a box that is not kept is zero everywhere.
//
// What it computes, per box (b, k) with keep != 0, for each pixel (y, x) of
// [ceil(y1), ceil(y2)) x [ceil(x1), ceil(x2)):
//   v = paste(y, x) * keep, th = v > 0.5;
//   area[b, k] += th, inter[b, k] += th & road[b, y, x],
//   rowany[b, k, y] |= th, and with a union, union[b, y, x, :] |= the
//   box's class words.
// The paste value is the plain version's f32 arithmetic in its order: the
// tap position (p - start) * (m - 1) / den and each tap weight
// max(1 - |pos - g|, 0) in round-to-nearest intrinsics (this file is built
// with -fmad=false as well); at most two taps are nonzero, floor(pos) and
// the one above it (absent at the mask's last row or column). The row stage
// is fma(w1, m[g0 + 1, n], w0 * m[g0, n]), the column stage
// fma(wx1, r[n0 + 1], wx0 * r[n0]): the two GEMMs' ascending accumulation,
// in which the zero-weight terms leave the sum as it is. Counts are exact
// integers; the union ORs class bits, so it is independent of order.
//
// Bound on an H100 SXM: operations on the CUDA cores, by the kept boxes'
// pixel count (per pixel one multiply, one FMA, the keep multiply and the
// compare). The bytes are small: the masks (5 MB at b16 x 100 x 28x28 f32),
// the road map read only under a thresholded pixel (at most 2 MB an image,
// L2-resident), the row map (1.7 MB), and, with a union, 4 B atomics per
// thresholded pixel and class word into a 33-MB-a-word bit map. No tensor
// cores or TMA apply.
//
// Design:
//  - one CTA per (box, stripe of 32 rows of the box); a box's stripes past
//    its height, and a box that is not kept, exit at once (a frame taller
//    than the grid's y extent loops over stripes);
//  - the box's columns are taken in chunks of `chunk` columns, whose taps
//    (n0, wx0, wx1 for each x) the CTA stages in shared memory: the
//    division of the tap position is paid once a column, not once a pixel
//    (one chunk covers the box at any width up to ~4000 for 28-wide masks);
//  - a warp owns a row: its lanes form r[n] of the row stage from two mask
//    rows (read through L1) into the warp's own row of shared memory, and
//    each lane's pixels read r[n0], r[n0 + 1] from there;
//  - counts gather in registers, reduce per warp, per CTA in shared
//    memory, and reach the [2, B*K] totals with two atomics a CTA; a row's
//    any-bit is a warp vote, stored by one lane (the map is zeroed first).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = 32;         // 4 rows a warp
constexpr int kMaxStripes = 65535;      // the grid's y extent
constexpr int kSmemBytes = 48 * 1024;   // a launch's without opting in
constexpr int kTapBytes = 12;           // a column's taps: float2 + int
constexpr unsigned kFull = 0xffffffffu;

// Align-corners position of pixel p in a box that starts at `start`, as
// ops/cuda/paste_stats.py paste_weights rounds it:
// ((p - start) * (size - 1)) / den.
__device__ __forceinline__ float position(int p, float start, int size,
                                          float den) {
  return __fdiv_rn(__fmul_rn(__fsub_rn((float)p, start), (float)(size - 1)),
                   den);
}

// The tap weight of grid point g: max(1 - |pos - g|, 0).
__device__ __forceinline__ float tap(float pos, float g) {
  return fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(pos, g))), 0.f);
}

__host__ __device__ inline size_t smem_bytes(int chunk, int mw) {
  return (size_t)chunk * kTapBytes + (size_t)kWarps * mw * sizeof(float);
}

// spans: [n_boxes, 6] f32 (y start, y stop, y den, x start, x stop, x den);
// keep: [n_boxes] f32; masks: [n_boxes, mh, mw] f32; road: [b, h, w] bytes;
// class_bits: [n_boxes, words] i32 (read only with union_bits); counts:
// [2, n_boxes] i32 (area, then inter); rowany: [n_boxes, h] bytes;
// union_bits: [b, h, w, words] i32 or null. n_boxes = b * k.
__global__ void __launch_bounds__(kThreads)
paste_stats_kernel(const float* __restrict__ spans,
                   const float* __restrict__ keep,
                   const float* __restrict__ masks,
                   const uint8_t* __restrict__ road,
                   const int* __restrict__ class_bits,
                   int* __restrict__ counts, uint8_t* __restrict__ rowany,
                   int* __restrict__ union_bits, int n_boxes, int k, int h,
                   int w, int mh, int mw, int words, int chunk) {
  const int box = blockIdx.x;
  const float kp = keep[box];
  if (kp == 0.f) return;
  const float* s = spans + (size_t)box * 6;
  const float y_start = s[0], y_den = s[2], x_start = s[3], x_den = s[5];
  const int y_first = (int)y_start, y_stop = (int)s[1];
  const int x_lo = (int)x_start;
  const int width = (int)s[4] - x_lo;
  if (y_first + (int)blockIdx.y * kRowsPerCta >= y_stop || width <= 0)
    return;

  extern __shared__ __align__(16) unsigned char smem[];
  float2* col_w = (float2*)smem;                                // [chunk]
  int* col_n = (int*)(col_w + chunk);                           // [chunk]
  __shared__ int cta_counts[2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* r_row = (float*)(col_n + chunk) + warp * mw;           // [mw]
  if (tid < 2) cta_counts[tid] = 0;
  const float* box_mask = masks + (size_t)box * mh * mw;
  const int img = box / k;
  const int* cbits =
      union_bits != nullptr ? class_bits + (size_t)box * words : nullptr;
  int area = 0, inter = 0;
  for (int y_lo = y_first + (int)blockIdx.y * kRowsPerCta; y_lo < y_stop;
       y_lo += (int)gridDim.y * kRowsPerCta) {
    const int y_hi = min(y_stop, y_lo + kRowsPerCta);
    for (int c0 = 0; c0 < width; c0 += chunk) {
      const int cols = min(chunk, width - c0);
      __syncthreads();                  // the last chunk's taps are read
      for (int i = tid; i < cols; i += kThreads) {
        const float pos = position(x_lo + c0 + i, x_start, mw, x_den);
        const float g0 = floorf(pos);
        const int n0 = (int)g0;
        col_w[i] = make_float2(tap(pos, g0),
                               n0 + 1 < mw ? tap(pos, g0 + 1.f) : 0.f);
        col_n[i] = n0;
      }
      __syncthreads();
      for (int y = y_lo + warp; y < y_hi; y += kWarps) {
        const float pos = position(y, y_start, mh, y_den);
        const float g0 = floorf(pos);
        const int m0 = (int)g0;
        const bool has1 = m0 + 1 < mh;
        const float w0 = tap(pos, g0);
        const float w1 = has1 ? tap(pos, g0 + 1.f) : 0.f;
        const float* m_row = box_mask + (size_t)m0 * mw;
        for (int n = lane; n < mw; n += 32) {
          const float a = __ldg(m_row + n);
          const float b = has1 ? __ldg(m_row + mw + n) : 0.f;
          r_row[n] = __fmaf_rn(w1, b, __fmul_rn(w0, a));
        }
        __syncwarp();
        const size_t row = ((size_t)img * h + y) * w + x_lo + c0;
        bool any = false;
        for (int i = lane; i < cols; i += 32) {
          const int n0 = col_n[i];
          const float2 cw = col_w[i];
          // r[n0 + 1] where n0 + 1 < mw; elsewhere cw.y is 0 and the term
          // adds 0
          const float r0 = r_row[n0];
          const float r1 = r_row[min(n0 + 1, mw - 1)];
          const float v =
              __fmul_rn(__fmaf_rn(cw.y, r1, __fmul_rn(cw.x, r0)), kp);
          if (v > 0.5f) {
            any = true;
            ++area;
            inter += road[row + i] != 0;
            if (union_bits != nullptr) {
              int* px = union_bits + (row + i) * words;
              for (int c = 0; c < words; ++c)
                if (cbits[c] != 0) atomicOr(px + c, cbits[c]);
            }
          }
        }
        if (__any_sync(kFull, any) && lane == 0)
          rowany[(size_t)box * h + y] = 1;
        __syncwarp();                   // r_row is read before the next row
      }
    }
  }
  area = __reduce_add_sync(kFull, area);
  inter = __reduce_add_sync(kFull, inter);
  if (lane == 0 && area != 0) {
    atomicAdd(&cta_counts[0], area);
    atomicAdd(&cta_counts[1], inter);
  }
  __syncthreads();
  if (tid == 0 && cta_counts[0] != 0) {
    atomicAdd(counts + box, cta_counts[0]);
    atomicAdd(counts + n_boxes + box, cta_counts[1]);
  }
}

}  // namespace

// See paste_stats_kernel for the layouts; counts and rowany (and union_bits
// where given) must be zero. `chunk` columns' taps and the warps' mask-wide
// rows must fit the 48 KB of shared memory a launch gets without opting in
// (ops/cuda/paste_stats.py column_chunk). Returns the first CUDA error of
// the launch.
extern "C" int mlk_paste_stats(const void* spans, const void* keep,
                               const void* masks, const void* road,
                               const void* class_bits, void* counts,
                               void* rowany, void* union_bits, int b, int k,
                               int h, int w, int mh, int mw, int words,
                               int chunk, void* stream) {
  if (mh < 1 || mw < 1 || chunk < 1 || words < 1 ||
      smem_bytes(chunk, mw) > (size_t)kSmemBytes)
    return (int)cudaErrorInvalidValue;
  const int n_boxes = b * k;
  if (n_boxes == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  const int stripes = min((h + kRowsPerCta - 1) / kRowsPerCta, kMaxStripes);
  const dim3 grid((unsigned)n_boxes, (unsigned)stripes);
  paste_stats_kernel<<<grid, kThreads, smem_bytes(chunk, mw),
                       (cudaStream_t)stream>>>(
      (const float*)spans, (const float*)keep, (const float*)masks,
      (const uint8_t*)road, (const int*)class_bits, (int*)counts,
      (uint8_t*)rowany, (int*)union_bits, n_boxes, k, h, w, mh, mw, words,
      chunk);
  return (int)cudaGetLastError();
}
