// Per-segment top-`cap` extraction for the NMS candidate pool.
//
// Replaces: segment_topk_pallas, masklab_tpu/ops/pallas/topk_kernel.py
// (pallas_call at :53), called from ops/nms.py _pool_body.
//
// What it computes: a score row of n values is padded with -inf to m*s
// (s = ceil(n/m)) and viewed row-major as [m, s], so column j is the strided
// segment {j, j+s, j+2s, ...}. For every (score row r, column j) it writes
// the `cap` largest values of that column in descending order, ties to the
// lowest row, with their flat indices i*s + j. Slots past the column's finite
// values hold (-inf, j): the TPU kernel's repeated (max, lowest argmax, mask)
// rounds land on row 0 once every row is -inf, and this kernel reproduces
// that. NaN scores are not supported (sigmoid outputs never are NaN).
//
// The scores are read where they lie: a [R0, G, n] view with any strides
// (row r = r0*G + g), flat positions >= n read as -inf, so the caller pads
// and transposes nothing. On the main path the scores are the [B, C, N]
// transpose of the classifier's contiguous [B, N, C] output (G = C, element
// stride C): a padded, transposed copy would read and write the 26.2 MB once
// more before this kernel reads it.
//
// Bound on an H100 SXM: bytes. At the 512 px pool ([16, 5, 81840] scores,
// cap 16) it must read 26.2 MB and write 6.6 MB (values f32 + indices i32):
// 32.8 MB / 3.35 TB/s = 9.8 us. To stay near it the selection may spend
// only some 15 instructions per score.
//
// Design:
//  - a block owns a tile of 32 consecutive logical columns u = j*G + g
//    (all G rows of a group, so on the main path a tile row is one
//    contiguous span of 32 floats and a warp's load is 128 coalesced
//    bytes), and 4 threads per column (8 where m > 128), each over a
//    contiguous slice of at most 32 of the m rows;
//  - a thread issues its slice's 32 loads at once into registers (no
//    per-row bounds where the slice is full), then sorts each 16 rows with
//    a bitonic network and keeps the top 16 of the two with a bitonic
//    merge: branch-free, so no warp waits on one lane's data-dependent
//    insertions, and every list is fully unrolled in registers (no local
//    memory);
//  - the slices' lists meet in a tree of bitonic merges through shared
//    memory;
//  - keys order by (value desc, row asc), a total order, so every
//    compare-exchange keeps the tie rule. Where every score of the block
//    has its low 16 bits zero (bf16-exact, as the main path's sigmoid
//    computed in bf16 is), a key is one u32: the order-preserving map of
//    the value's high half over 0xFFFF - row, and a compare-exchange is one
//    integer max and one min. Elsewhere (or with a -0.0) a key is the
//    (value, row) pair, about four times the instructions.
// TMA cannot fetch the tiles: its global strides must be multiples of 16
// bytes, and the main path's element stride is C * 4 = 20 bytes.
//
// What holds it above its bound (PERF.md, section 6): its reads of 128
// bytes a warp run below the card's streaming rate, and the sorting
// networks' integer operations (half the FP32 issue rate) overlap the loads
// only across blocks. Earlier designs were slower: one thread per column
// with dependent loads, and slices of register insertion sorts (a warp runs
// a lane's insertion whenever any lane needs one, i.e. on almost every row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kList = 16;           // list length: the largest cap
constexpr int kRows = 2 * kList;    // rows of one slice at most
constexpr int kTile = 32;           // logical columns per block
constexpr int kMaxSlices = 8;       // threads per column at most
constexpr int kMaxThreads = kTile * kMaxSlices;
constexpr int kMinBlocks = 3;       // per SM: at most 85 registers a thread

// ---- (value, row) pair keys, any float ----
struct Pair {
  float v;
  int r;
};

__device__ __forceinline__ bool above(Pair a, Pair b) {
  return a.v > b.v || (a.v == b.v && a.r < b.r);
}
// afterwards a ranks above b
__device__ __forceinline__ void order(Pair& a, Pair& b) {
  const bool swap = above(b, a);
  const Pair t = a;
  a.v = swap ? b.v : a.v;
  a.r = swap ? b.r : a.r;
  b.v = swap ? t.v : b.v;
  b.r = swap ? t.r : b.r;
}
__device__ __forceinline__ Pair higher(Pair a, Pair b) {
  return above(a, b) ? a : b;
}

struct PairKeys {
  using Key = Pair;
  static constexpr int kBytes = 8;
  __device__ static Key make(float v, int field) { return {v, field}; }
  __device__ static float value(Key k) { return k.v; }
  __device__ static int row(Key k) { return k.r; }
  // shared memory holds `count` values, then `count` rows
  __device__ static void put(unsigned char* sm, int i, int count, Key k) {
    reinterpret_cast<float*>(sm)[i] = k.v;
    reinterpret_cast<int*>(sm)[count + i] = k.r;
  }
  __device__ static Key get(const unsigned char* sm, int i, int count) {
    return {reinterpret_cast<const float*>(sm)[i],
            reinterpret_cast<const int*>(sm)[count + i]};
  }
};

// ---- one-u32 keys, bf16-exact values other than -0.0 ----
__device__ __forceinline__ void order(uint32_t& a, uint32_t& b) {
  const uint32_t hi = max(a, b);
  b = min(a, b);
  a = hi;
}
__device__ __forceinline__ uint32_t higher(uint32_t a, uint32_t b) {
  return max(a, b);
}

struct PackedKeys {
  using Key = uint32_t;
  // field < 0x10000; 0xFFFF - field == 0xFFFF ^ field
  __device__ static Key make(float v, int field) {
    const uint32_t b = __float_as_uint(v);
    const uint32_t mono = b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
    return (mono & 0xFFFF0000u) | (0xFFFFu ^ (uint32_t)field);
  }
  __device__ static float value(Key k) {
    const uint32_t hi = k >> 16;
    const uint32_t b = (hi & 0x8000u) ? (hi ^ 0x8000u) : (~hi & 0xFFFFu);
    return __uint_as_float(b << 16);
  }
  __device__ static int row(Key k) { return (int)(0xFFFFu ^ (k & 0xFFFFu)); }
  __device__ static void put(unsigned char* sm, int i, int, Key k) {
    reinterpret_cast<uint32_t*>(sm)[i] = k;
  }
  __device__ static Key get(const unsigned char* sm, int i, int) {
    return reinterpret_cast<const uint32_t*>(sm)[i];
  }
};

// sorts 16 keys into descending order (bitonic network)
template <class Key>
__device__ __forceinline__ void sort16(Key (&k)[kList]) {
#pragma unroll
  for (int w = 2; w <= kList; w <<= 1) {
#pragma unroll
    for (int d = w >> 1; d > 0; d >>= 1) {
#pragma unroll
      for (int a = 0; a < kList; ++a) {
        const int b = a ^ d;
        if (b > a) {
          if ((a & w) == 0) order(k[a], k[b]);
          else order(k[b], k[a]);
        }
      }
    }
  }
}

// a := the top 16 of a and b, both descending: the elementwise higher of a
// and reversed b is bitonic and holds them; a half-cleaner cascade sorts it
template <class Key>
__device__ __forceinline__ void merge16(Key (&a)[kList],
                                        const Key (&b)[kList]) {
#pragma unroll
  for (int i = 0; i < kList; ++i) a[i] = higher(a[i], b[kList - 1 - i]);
#pragma unroll
  for (int d = kList / 2; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < kList; ++i)
      if ((i ^ d) > i) order(a[i], a[i ^ d]);
  }
}

// The selection on one slice's loaded rows, the slices' merge and the
// store, with one kind of key. Every thread of the block calls it. A key's
// row field is 32 * slice + k for row k of the slice: it orders like the
// row and leaves the low five bits to k.
template <class T>
__device__ __forceinline__ void select(const float (&raw)[kRows], int p,
                                       int q, int slices, int per,
                                       unsigned char* smem, bool write,
                                       float* vo, int* io, int s, int j,
                                       int cap) {
  using Key = typename T::Key;
  const int field = p * kRows;
  Key a[kList];
#pragma unroll
  for (int k = 0; k < kList; ++k) a[k] = T::make(raw[k], field | k);
  sort16(a);
  if (per > kList) {
    Key b[kList];
#pragma unroll
    for (int k = 0; k < kList; ++k)
      b[k] = T::make(raw[kList + k], field | (kList + k));
    sort16(b);
    merge16(a, b);
  }
  // tree merge: at distance d, slice p + d hands its list to slice p
  const int count = (slices / 2) * kList * kTile;
  for (int d = 1; d < slices; d <<= 1) {
    const int slot = p / (2 * d);
    if (p % (2 * d) == d) {
#pragma unroll
      for (int t = 0; t < kList; ++t)
        T::put(smem, (slot * kList + t) * kTile + q, count, a[t]);
    }
    __syncthreads();
    if (p % (2 * d) == 0) {
      Key b[kList];
#pragma unroll
      for (int t = 0; t < kList; ++t)
        b[t] = T::get(smem, (slot * kList + t) * kTile + q, count);
      merge16(a, b);
    }
    __syncthreads();
  }
  if (!write) return;
#pragma unroll
  for (int t = 0; t < kList; ++t) {
    if (t < cap) {
      const float v = T::value(a[t]);
      const int f = T::row(a[t]);
      const int row = v == -INFINITY ? 0 : (f / kRows) * per + f % kRows;
      vo[(int64_t)t * s] = v;
      io[(int64_t)t * s] = row * s + j;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
segment_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int* __restrict__ idx, int g_rows, int64_t stride0,
                    int64_t stride_g, int64_t es, int n, int m, int s,
                    int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slices = blockDim.y;
  const int q = threadIdx.x, p = threadIdx.y;
  const int r0 = blockIdx.y;
  const int u = blockIdx.x * kTile + q;         // logical column j*G + g
  const bool live = u < s * g_rows;
  const int j = live ? u / g_rows : 0;
  const int g = live ? u - j * g_rows : 0;

  // rows of this thread's slice: [lo, lo + per), clipped to the valid rows
  const int per = (m + slices - 1) / slices;
  const int lo = p * per;
  int iend = 0;
  if (live && j < n) iend = min(m, (n - j + s - 1) / s);
  iend = min(iend, lo + per);
  const int64_t row_step = (int64_t)s * es;
  const float* col = x + r0 * stride0 + g * stride_g + (int64_t)j * es +
                     lo * row_step;

  float raw[kRows];
  if (lo + kRows <= iend) {       // a full slice: no bounds per row
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      raw[k] = __ldg(col);
      col += row_step;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      raw[k] = lo + k < iend ? __ldg(col) : -INFINITY;
      col += row_step;
    }
  }
  uint32_t low = 0;
  bool neg_zero = false;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const uint32_t bits = __float_as_uint(raw[k]);
    low |= bits;
    neg_zero |= bits == 0x80000000u;
  }
  const bool packed = __syncthreads_and((low & 0xFFFFu) == 0 && !neg_zero);

  const int64_t r = (int64_t)r0 * g_rows + g;
  float* vo = vals + r * cap * s + j;
  int* io = idx + r * cap * s + j;
  const bool write = live && p == 0;
  if (packed)
    select<PackedKeys>(raw, p, q, slices, per, smem, write, vo, io, s, j,
                       cap);
  else
    select<PairKeys>(raw, p, q, slices, per, smem, write, vo, io, s, j, cap);
}

}  // namespace

// x: score rows as a [r0, g_rows, n] f32 view with strides (stride0,
// stride_g, es) in elements; vals: [r0 * g_rows, cap, s] f32; idx: the same
// in i32, contiguous. s = ceil(n / m). 1 <= cap <= 16, 1 <= m <= 256.
// Returns cudaGetLastError() after the launch (an unsupported argument
// returns cudaErrorInvalidValue).
extern "C" int mlk_segment_topk(const void* x, void* vals, void* idx, int r0,
                                int g_rows, long long stride0,
                                long long stride_g, long long es, int n,
                                int m, int s, int cap, void* stream) {
  if (cap < 1 || cap > kList || m < 1 || m > kMaxSlices * kRows ||
      g_rows < 1 || s != (n + m - 1) / m)
    return (int)cudaErrorInvalidValue;
  if (r0 == 0 || s == 0) return (int)cudaGetLastError();
  // threads per column: the fewest of 4 and 8 whose slices fit kRows rows
  const int slices = m > 4 * kRows ? kMaxSlices : 4;
  const int cols = s * g_rows;
  dim3 grid((unsigned)((cols + kTile - 1) / kTile), (unsigned)r0);
  dim3 block((unsigned)kTile, (unsigned)slices);
  const size_t smem = (size_t)(slices / 2) * kList * kTile * PairKeys::kBytes;
  segment_topk_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)vals, (int*)idx, g_rows, stride0, stride_g,
      es, n, m, s, cap);
  return (int)cudaGetLastError();
}
