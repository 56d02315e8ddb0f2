// Greedy NMS keep-mask over score-sorted boxes, one thread block cluster per
// candidate set.
//
// Replaces: nms_keep_mask_pallas, masklab_tpu/ops/pallas/nms_kernel.py
// (pallas_call at :93), and batched_nms_keep_mask_pallas (:106), which
// compute the same keep-mask as the XLA fixpoint ops/nms.py nms_keep_mask
// used by both NMS stages.
//
// What it computes: boxes is [R, K, 4] (y1, x1, y2, x2) in score order, valid
// is [R, K]. Box i is kept when it is valid, no earlier KEPT box j has
// IoU(j, i) > t (strict), and fewer than max_outputs boxes were kept before
// it. The IoU is the exact-union form of ops/boxes.py iou_yxyx, evaluated in
// the same operation order with round-to-nearest intrinsics and no FMA
// contraction (this file is also built with -fmad=false), so keep decisions
// at IoU == t edges match the reference bit for bit.
//
// Bound on an H100 SXM: latency. The bytes (boxes 16 B + valid 1 B in, keep
// 1 B out per box) and the K^2/2 IoUs are both under a microsecond at the
// main-path shapes (stage 1: 80 x K=256, stage 2: 16 x K=500) when spread
// over the card; what remains is the greedy chain, one dependent step per
// kept box. The first design was far from that: one 1024-thread block per
// set built the K^2/2-IoU bitmask alone (16 blocks on 132 SMs in stage 2),
// as one (row, word) task per warp with two IoUs per lane, two ballots and
// a branchy IEEE division, and its sweep walked all K boxes, removed or
// not, with a byte store per box.
//
// Design:
// - The suppression bitmask, bit (j, i) set for j < i and IoU(j, i) > t, as
//   ceil(K/64) 64-bit words per row, is built by a cluster of up to 8 CTAs
//   per set (the smallest power of two that puts >= 256 CTAs, about two per
//   SM, on the card, or more where the rows need the room). Row j is built
//   by CTA j % size. A warp takes one word of 32 of the CTA's rows: each
//   lane holds its row's box in registers and tests it against the word's
//   64 boxes, read by all lanes at once (a shared-memory broadcast), so the
//   64 IoUs are independent, branch-free and need no ballot. Words left of
//   a row's diagonal are never read and not built.
// - Where the whole mask fits in one CTA's shared memory (K <= ~1280) each
//   word is stored straight into CTA 0's shared memory through distributed
//   shared memory, so the sweep reads only its own shared memory; beyond
//   that (up to MAX_K = 2048) each row stays with the CTA that built it and
//   the sweep reads it through distributed shared memory.
// - After cluster.sync(), one warp of CTA 0 runs the greedy sweep. Lane w
//   holds word w of the removed mask, seeded with the invalid boxes. The
//   next box to keep is the lowest one not removed: each lane offers the
//   first open box of its word (__ffsll) and one __reduce_min_sync picks
//   it, so every step of the dependent chain keeps a box and ORs its row
//   into the removed words, and the sweep ends after max_outputs keeps or
//   when every box is removed. Keeping the first max_outputs boxes of the
//   uncapped greedy is what the cap means (suppression flows only from kept
//   boxes, and an invalid box is never kept). Keep bits gather in the
//   lanes' registers and the whole CTA writes the keep bytes at the end in
//   one coalesced pass.
// - The rows are built in full rather than lazily for the kept boxes only:
//   lazily, each kept box would add a CTA-wide IoU pass and a barrier to the
//   serial chain, while the full build runs in parallel before it. Measured
//   on the card, the build is still the larger part (chip_smoke.py's
//   build_ms and sweep_ms).
// The build-only instance (kSweep = false) exists for timing the two phases
// apart and is not on any path of the package.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;       // 16 warps build, one of CTA 0 sweeps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 32;       // one removed-word per lane of the sweep warp
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kTargetCtas = 256;    // about two CTAs per SM of the H100's 132
constexpr int kMaxSmem = 227 * 1024;

typedef unsigned long long u64;

struct Plan {
  int cluster;   // CTAs per set
  int shift;     // row j lives in CTA j & ((1 << shift) - 1), slot j >> shift
  int rows;      // mask rows each CTA's shared memory holds
  int smem;      // dynamic shared memory bytes per CTA
};

Plan make_plan(int r, int k) {
  const int words = (k + 63) / 64;
  const int fixed = 2 * words * 8 + 20 * k;   // invalid + kept words, boxes, areas
  Plan p;
  p.cluster = 1;
  while (p.cluster < kMaxCluster && r * p.cluster < kTargetCtas) p.cluster *= 2;
  if (fixed + k * words * 8 <= kMaxSmem) {
    p.shift = 0;           // every row in CTA 0
    p.rows = k;
  } else {
    while (p.cluster < kMaxCluster &&
           fixed + (k + p.cluster - 1) / p.cluster * words * 8 > kMaxSmem)
      p.cluster *= 2;
    p.shift = __builtin_ctz(p.cluster);
    p.rows = (k + p.cluster - 1) / p.cluster;
  }
  p.smem = fixed + p.rows * words * 8;
  return p;
}

// IoU(j, i) > thr, in ops/boxes.py iou_yxyx's operation order, without
// branches so that a lane's IoUs overlap. A pair without overlap or union
// (IoU 0, most pairs) divides 1 by 1 and discards the quotient, so that the
// IEEE division's check never sends it down the slow path.
__device__ __forceinline__ bool suppresses(const float4 bj, const float4 bi,
                                           float area_j, float area_i,
                                           float thr) {
  const float in_h = fmaxf(0.f, __fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)));
  const float in_w = fmaxf(0.f, __fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)));
  const float inter = __fmul_rn(in_h, in_w);
  const float uni = __fsub_rn(__fadd_rn(area_j, area_i), inter);
  const bool overlap = (uni > 0.f) & (inter != 0.f);
  const float q = __fdiv_rn(overlap ? inter : 1.f, overlap ? uni : 1.f);
  return (overlap ? q : 0.f) > thr;
}

// The greedy sweep, run by one warp: lane w holds word w of the removed
// mask (seeded with `invalid_word`, the invalid boxes). The lowest box not
// removed is kept: each lane offers the first open box of its word and one
// warp-wide min picks it; its row is ORed into the removed words right of
// it. `rows_of(home)` is the shared memory holding rows j with
// j % (1 << shift) == home. The step has no branch but the loop's own.
// Returns lane w's word of keep bits.
template <typename RowsOf>
__device__ __forceinline__ u64 sweep(u64 invalid_word, const u64* local,
                                     int k, int max_outputs, int shift,
                                     RowsOf rows_of) {
  const int lane = threadIdx.x & 31;
  const int words = (k + 63) >> 6;
  const int home_mask = (1 << shift) - 1;
  const int word = min(lane, words - 1);   // lanes past the last word read it
  u64 removed = lane < words ? invalid_word : ~0ull;
  u64 kept_bits = 0;
  for (int count = 0; count < max_outputs; ++count) {
    const unsigned offer = removed == ~0ull ? 0xffffffffu
        : (unsigned)(lane * 64 + __ffsll((long long)~removed) - 1);
    const unsigned i = __reduce_min_sync(0xffffffffu, offer);
    if (i == 0xffffffffu) break;
    const int w = (int)(i >> 6), home = (int)i & home_mask;
    const u64* rows = home == 0 ? local : rows_of(home);
    const u64 row = rows[(size_t)(i >> shift) * words + word];
    const u64 own = lane == w ? 1ull << (i & 63) : 0ull;
    kept_bits |= own;
    removed |= own | (lane >= w && lane < words ? row : 0ull);
  }
  return kept_bits;
}

template <bool kSweep>
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, float thr, int max_outputs, int rows, int shift) {
  cg::cluster_group cluster = cg::this_cluster();
  const int size = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int words = (k + 63) >> 6;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);     // [k]
  u64* mask = reinterpret_cast<u64*>(sbox + k);       // [rows, words]
  u64* invalid = mask + (size_t)rows * words;         // [words], CTA 0
  u64* kept = invalid + words;                        // [words], CTA 0
  float* area = reinterpret_cast<float*>(kept + words);   // [k]

  // Tell the cluster this CTA runs; wait for the others only before the
  // first remote store, so the barrier's latency overlaps the loads below.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int set = blockIdx.x / size;
  const float* b = boxes + (size_t)set * k * 4;
  const uint8_t* v = valid + (size_t)set * k;
  uint8_t* out = keep + (size_t)set * k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const bool aligned = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float4 q = aligned ? reinterpret_cast<const float4*>(b)[i]
                             : make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
    sbox[i] = q;
    area[i] = __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
  }
  if (rank == 0) {
    // bits at i >= k are set too: those boxes do not exist
    for (int w = warp; w < words; w += kThreads / 32) {
      const int i0 = w * 64 + lane, i1 = i0 + 32;
      const unsigned lo = __ballot_sync(0xffffffffu, i0 >= k || !v[i0]);
      const unsigned hi = __ballot_sync(0xffffffffu, i1 >= k || !v[i1]);
      if (lane == 0) invalid[w] = ((u64)hi << 32) | lo;
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // Row j is built by CTA j % size. A task is one word of 32 of the CTA's
  // rows: lane l owns row j (its box in registers) and tests it against the
  // word's 64 boxes, which every lane reads at once (a shared-memory
  // broadcast), so its 64 IoUs are independent and need no ballot. Words
  // left of a row's diagonal are never read and not built.
  const int home_mask = (1 << shift) - 1;
  const int my_rows = rank < k ? (k - rank + size - 1) / size : 0;
  const int tasks = (my_rows + 31) / 32 * words;
  for (int t = warp; t < tasks; t += kWarps) {
    const int block = t / words, w = t - block * words;
    const int local = block * 32 + lane;
    const int j = rank + local * size;
    const bool live = local < my_rows && (j >> 6) <= w;
    if (!__any_sync(0xffffffffu, live)) continue;
    const int jc = min(j, k - 1);
    const float4 bj = sbox[jc];
    const float aj = area[jc];
    const int i0 = w * 64, n = min(64, k - i0);
    u64 bits = 0;
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const int i = i0 + c;
      bits |= (u64)((i > j) & suppresses(bj, sbox[i], aj, area[i], thr)) << c;
    }
    if (live) {
      const int home = j & home_mask;
      u64* dst = home == rank ? mask : cluster.map_shared_rank(mask, home);
      dst[(size_t)(j >> shift) * words + w] = bits;
    }
  }
  cluster.sync();   // every row is complete and visible to CTA 0

  if (rank == 0) {
    if (!kSweep) {
      if (threadIdx.x == 0) out[0] = (uint8_t)(mask[0] & 1);   // keep the build live
    } else {
      if (warp == 0) {
        // shift 0 as a constant makes every row read a local shared load
        const auto remote = [&](int home) { return cluster.map_shared_rank(mask, home); };
        const u64 word = invalid[min(lane, words - 1)];
        const u64 kept_bits = shift == 0
            ? sweep(word, mask, k, max_outputs, 0, remote)
            : sweep(word, mask, k, max_outputs, shift, remote);
        if (lane < words) kept[lane] = kept_bits;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < k; i += kThreads)
        out[i] = (uint8_t)((kept[i >> 6] >> (i & 63)) & 1ull);
    }
  }
  // Rows spread over the cluster: no CTA leaves while CTA 0 may still read
  // its rows. Gathered in CTA 0, the other CTAs are done after the build.
  if (shift > 0) cluster.sync();
}

template <bool kSweep>
int launch(const void* boxes, const void* valid, void* keep, int r, int k,
           float thr, int max_outputs, void* stream) {
  if (r == 0 || k == 0) return (int)cudaGetLastError();
  if ((k + 63) / 64 > kMaxWords) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(r, k);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(r * p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, nms_keep_kernel<kSweep>, (const float*)boxes,
      (const uint8_t*)valid, (uint8_t*)keep, k, thr, max_outputs, p.rows,
      p.shift);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// Shared memory one CTA needs for r candidate sets of k boxes.
extern "C" int mlk_nms_keep_smem_bytes(int r, int k) {
  return make_plan(r, k).smem;
}

// Lets the kernel use up to 227 KB of dynamic shared memory on the current
// device; called once per device before the first launch there.
extern "C" int mlk_nms_keep_init(void) {
  cudaError_t e = cudaFuncSetAttribute(
      nms_keep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(nms_keep_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return (int)e;
}

// boxes: [r, k, 4] f32; valid, keep: [r, k] bool (one byte each).
// k <= 64 * 32. Returns the first CUDA error of the launch.
extern "C" int mlk_nms_keep(const void* boxes, const void* valid, void* keep,
                            int r, int k, float thr, int max_outputs,
                            void* stream) {
  return launch<true>(boxes, valid, keep, r, k, thr, max_outputs, stream);
}

// The bitmask build alone (keep is not computed), for timing the two phases
// apart.
extern "C" int mlk_nms_keep_build_only(const void* boxes, const void* valid,
                                       void* keep, int r, int k, float thr,
                                       int max_outputs, void* stream) {
  return launch<false>(boxes, valid, keep, r, k, thr, max_outputs, stream);
}
