// Segment combine for Hopper (sm_90a): per-segment sum / mean / max of the
// feature rows of each segment's participating edges, in edge order.
//
// Replaces dgraph_tpu/ops/feat.py:41 segment_combine / :84 combine_edges
// (XLA in the reference, no Pallas kernel): for each live edge slot j, the
// row of rank nbrs[j] in the sorted tablet `subj` (if it has one) is
// combined into segment seg[j]. Outputs out [n_seg, d] f32, cnt [n_seg]
// (participating edges), ecnt [n_seg] (live edges). A segment with no
// participating edge gets a zero row; `mean` is one IEEE division of the
// sum by the count; slots whose seg lies outside [0, n_seg) are dropped.
//
// Determinism is the contract. Every output element is folded in edge
// order by one thread, so every run and every CUDA-graph replay gives the
// same bits, equal to numpy's sequential np.add.at / np.maximum.at (the
// host route, dgraph_tpu/engine/feat.py:host_combine) for any float input.
// That order forbids a tree over one segment's edges; it leaves the
// columns, and the loads, free to spread.
//
// What bounds it, and what each pass does about it:
//   * Bytes: each live edge's (nbr, seg), each participating row (d * 4
//     bytes, 1,536 at d = 384) and the outputs, once.
//   * The FADD chain of the longest segment: n dependent adds per column,
//     ~4 cycles each (206,321 edges: ~0.42 ms at 1.98 GHz). A hub walked by
//     one block with a few rows in flight sits far above both.
// Two launches, no float atomics, no allocation, no host synchronisation:
//   1. group_edges, grid-stride over max(live edges, n_seg + 1): resolves
//      each live edge's tablet row by binary search (-1: none), writes the
//      segment offsets by a lower-bound search of the grouped keys (seg
//      itself when the caller's live prefix is non-decreasing, else the
//      wrapper's stable sort of it), and routes every segment of at least
//      kLongMin live edges to a slot list: slot t names the long segment
//      whose first multiple of kLongMin is t * kLongMin (-1 if none), so the
//      list needs no counter and no clearing.
//   2. combine, one kernel with both paths, five warps a block:
//      - short segments, one warp each (grid-stride): lanes over columns
//        (float4 when d % 4 == 0 and aligned), 32 row ids fetched at once
//        and broadcast by shuffle, kShortAhead rows loaded ahead of the
//        adds;
//      - long segments, one (segment, kTileCols-column tile) item per
//        block (grid-stride over slots x tiles), warp-specialised: four
//        producer warps copy the tile's rows, two threads a row (row ids
//        loaded three stages ahead), into a kStages-deep shared-memory
//        ring with cp.async (16-byte pieces), a non-participating row
//        staged as the fold's identity (+0 for sums, which never changes
//        an accumulator that starts at +0; -inf for max); the fifth warp
//        folds the ring in edge order, one column per lane, its
//        shared-memory reads a batch ahead of the adds, so only the chain
//        is serial. A named barrier pair per ring slot (landed / folded)
//        hands stages over, kSlack landed stages queued ahead of the
//        folder. Narrow tiles spread one hub over many SMs (48 blocks at
//        d = 384): on the H100 a block with 32-column tiles gathered only
//        ~16 GB/s of random 128-byte rows and left its folder waiting
//        (tools/combine_variants.py times the alternatives).
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // group_edges
constexpr int kCombineThreads = 160;   // combine: five warps a block; on
constexpr int kWarps = kCombineThreads / 32;   // the long path four stage
constexpr int kProducers = 128;                // the ring and the fifth,
constexpr int kFolder = kProducers / 32;       // the folder, folds it
constexpr int kLongMin = 512;      // live edges of a segment on the long path
constexpr int kTileCols = 8;       // columns of one long item (<= 32)
constexpr int kStageFloats = 4096; // one ring stage: 16 KB
constexpr int kStageRows = kStageFloats / kTileCols;
constexpr int kStages = 6;         // ring depth
constexpr int kSlack = 2;          // landed stages queued ahead of the folder
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 98,304
constexpr int kFull = 1;           // named barriers: stage b landed,
constexpr int kEmpty = kFull + kStages;   // stage b folded
constexpr int kRowShare = 2;       // producer threads per row of a stage
constexpr int kShortCols = 4;      // columns (of T) per lane in a short pass
constexpr int kShortAhead = 4;     // rows loaded ahead of the adds
static_assert(kEmpty + kStages <= 16, "a block has 16 named barriers");
static_assert(kTileCols <= 32, "one folding lane per tile column");
static_assert(kCombineThreads == kProducers + 32, "producers and a folder");

enum Agg { kSum = 0, kMean = 1, kMax = 2 };

// -- grouping ----------------------------------------------------------------

__device__ __forceinline__ int64_t live_count(int64_t n_host,
                                              const void* n_dev, int dev64) {
  if (n_dev == nullptr) return n_host;
  const int64_t n = dev64 ? *static_cast<const int64_t*>(n_dev)
                          : *static_cast<const int32_t*>(n_dev);
  return n < 0 ? 0 : (n > n_host ? n_host : n);
}

// the grouped key of slot j: -1 below segment 0, n_seg past the last one
// (and for every slot at or past the live count)
__device__ __forceinline__ int32_t key_at(const int32_t* __restrict__ keys,
                                          int64_t j, int64_t n_live,
                                          int32_t n_seg) {
  if (j >= n_live) return n_seg;
  const int32_t k = keys[j];
  return k < 0 ? -1 : (k > n_seg ? n_seg : k);
}

// first j in [lo, hi) with key_at(j) >= s, hi if none
__device__ int64_t lower_bound(const int32_t* __restrict__ keys, int64_t lo,
                               int64_t hi, int64_t n_live, int32_t n_seg,
                               int32_t s) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (key_at(keys, mid, n_live, n_seg) < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) group_edges(
    const int32_t* __restrict__ subj, int64_t rows,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ keys,
    const int64_t* __restrict__ order, int64_t n_host, const void* n_dev,
    int dev64, int32_t n_seg, int32_t* __restrict__ rows_out,
    int32_t* __restrict__ seg_off, int32_t* __restrict__ slots) {
  const int64_t n_live = live_count(n_host, n_dev, dev64);
  const int64_t n_slots = (n_live + kLongMin - 1) / kLongMin;
  const int64_t items = n_live > n_seg + 1 ? n_live : n_seg + 1;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < items;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i <= n_seg) {
      seg_off[i] = (int32_t)lower_bound(keys, 0, n_live, n_live, n_seg,
                                        (int32_t)i);
    }
    if (i < n_live) {
      const int32_t k = key_at(keys, i, n_live, n_seg);
      if (k >= 0 && k < n_seg) {
        const int32_t nb = nbrs[order ? order[i] : i];
        // first position with subj[pos] >= nb (searchsorted, side left)
        int64_t lo = 0, hi = rows;
        while (lo < hi) {
          const int64_t mid = (lo + hi) >> 1;
          if (subj[mid] < nb) lo = mid + 1; else hi = mid;
        }
        rows_out[i] = (lo < rows && subj[lo] == nb) ? (int32_t)lo : -1;
      }
    }
    if (i < n_slots) {
      // slot i owns the segment at p = i * kLongMin if p is the first
      // multiple of kLongMin inside it and the segment is long
      const int64_t p = i * kLongMin;
      const int32_t s = key_at(keys, p, n_live, n_seg);
      int32_t owner = -1;
      if (s >= 0 && s < n_seg &&
          (p < kLongMin || key_at(keys, p - kLongMin, n_live, n_seg) != s)) {
        const int64_t a = lower_bound(keys, p < kLongMin ? 0 : p - kLongMin + 1,
                                      p + 1, n_live, n_seg, s);
        if (key_at(keys, a + kLongMin - 1, n_live, n_seg) == s) owner = s;
      }
      slots[i] = owner;
    }
  }
}

// -- folding -------------------------------------------------------------------

// np.maximum(a, b) as numpy computes it on x86 (maxps, then a's NaN kept):
// a when a > b or a is NaN, else b; so equal values (+0 / -0) give b.
// With a NaN b read as +inf, that is one unordered compare on a, !(a <=
// b'), and a select: two dependent operations on the accumulator's chain.
__device__ __forceinline__ float npmax(float a, float b) {
  const float bq = isnan(b) ? INFINITY : b;
  return !(a <= bq) ? a : b;
}
template <bool kIsMax>
__device__ __forceinline__ float fold1(float a, float b) {
  return kIsMax ? npmax(a, b) : a + b;
}
template <bool kIsMax>
__device__ __forceinline__ void fold(float& a, float b) { a = fold1<kIsMax>(a, b); }
template <bool kIsMax>
__device__ __forceinline__ void fold(float4& a, float4 b) {
  a.x = fold1<kIsMax>(a.x, b.x); a.y = fold1<kIsMax>(a.y, b.y);
  a.z = fold1<kIsMax>(a.z, b.z); a.w = fold1<kIsMax>(a.w, b.w);
}
__device__ __forceinline__ void set_all(float& a, float v) { a = v; }
__device__ __forceinline__ void set_all(float4& a, float v) {
  a = make_float4(v, v, v, v);
}
__device__ __forceinline__ float fin(float a, int agg, int32_t cnt) {
  if (cnt == 0) return 0.0f;
  return agg == kMean ? __fdiv_rn(a, (float)cnt) : a;
}
__device__ __forceinline__ float4 fin(float4 a, int agg, int32_t cnt) {
  return make_float4(fin(a.x, agg, cnt), fin(a.y, agg, cnt),
                     fin(a.z, agg, cnt), fin(a.w, agg, cnt));
}

// -- the short path: one warp walks one segment ---------------------------------

// T = float or float4; dv = columns of T per row
template <typename T, bool kIsMax>
__device__ void short_segment(const T* __restrict__ vecs, int64_t dv,
                              const int32_t* __restrict__ rows_in, int32_t lo,
                              int32_t hi, int agg, int64_t s,
                              T* __restrict__ out,
                              int32_t* __restrict__ cnt_out,
                              int32_t* __restrict__ ecnt_out, int lane) {
  const float ident = kIsMax ? -INFINITY : 0.0f;
  for (int64_t c0 = 0; c0 < dv; c0 += 32 * kShortCols) {
    T acc[kShortCols];
#pragma unroll
    for (int k = 0; k < kShortCols; ++k) set_all(acc[k], ident);
    int32_t cnt = 0;
    for (int32_t j0 = lo; j0 < hi; j0 += 32) {
      const int32_t mine = j0 + lane < hi ? rows_in[j0 + lane] : -1;
      const int32_t m = hi - j0 < 32 ? hi - j0 : 32;
      for (int u0 = 0; u0 < m; u0 += kShortAhead) {
        int32_t r[kShortAhead];
        T v[kShortAhead][kShortCols];
#pragma unroll
        for (int u = 0; u < kShortAhead; ++u)
          r[u] = __shfl_sync(0xffffffffu, mine, u0 + u);
#pragma unroll
        for (int u = 0; u < kShortAhead; ++u) {
#pragma unroll
          for (int k = 0; k < kShortCols; ++k) {
            const int64_t col = c0 + lane + 32 * k;
            if (r[u] >= 0 && col < dv) v[u][k] = vecs[(int64_t)r[u] * dv + col];
            else set_all(v[u][k], ident);
          }
        }
#pragma unroll
        for (int u = 0; u < kShortAhead; ++u) {
          if (r[u] >= 0) {
            ++cnt;
#pragma unroll
            for (int k = 0; k < kShortCols; ++k) fold<kIsMax>(acc[k], v[u][k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kShortCols; ++k) {
      const int64_t col = c0 + lane + 32 * k;
      if (col < dv) out[s * dv + col] = fin(acc[k], agg, cnt);
    }
    if (c0 == 0 && lane == 0) {
      cnt_out[s] = cnt;
      ecnt_out[s] = hi - lo;
    }
  }
}

// -- the long path: a block stages one column tile, warp 0 folds it -------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One producer thread's share of a ring stage: kShare threads copy each
// row of the tile (one 32-byte sector at kTileCols = 8), so a warp's
// copy touches 32 / kShare whole rows; a thread copies kUnitsPer pieces
// of 16 bytes (vec4) or 4 bytes of each of its kRowsPer rows.
template <bool kVec4>
struct Stage {
  static constexpr int W = kVec4 ? 4 : 1;
  static constexpr int kUnits = kTileCols / W;
  static constexpr int kShare = kRowShare;
  static constexpr int kUnitsPer = kUnits / kShare;
  static constexpr int kRowStride = kProducers / kShare;
  static constexpr int kRowsPer = kStageRows / kRowStride;
  static constexpr int32_t kNone = INT32_MIN;   // past the segment's end
  static_assert(kUnits % kShare == 0 && kStageRows % kRowStride == 0,
                "whole rows per stage");

  int32_t ids[kRowsPer];

  __device__ __forceinline__ void load_ids(const int32_t* __restrict__ seg_rows,
                                           int32_t n, int32_t first) {
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q) {
      const int32_t row = first + threadIdx.x / kShare + q * kRowStride;
      ids[q] = row < n ? seg_rows[row] : kNone;
    }
  }

  // issue the copies into `stage`; returns the participating rows (one
  // thread of each row counts)
  __device__ __forceinline__ int32_t issue(const float* __restrict__ vecs,
                                           int64_t d, int64_t col0,
                                           float* stage, float ident) const {
    const int u0 = (threadIdx.x % kShare) * kUnitsPer;
    int32_t got = 0;
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q) {
      const int32_t r = ids[q];
      if (r == kNone) continue;
      float* dst = stage + (threadIdx.x / kShare + q * kRowStride) * kTileCols;
      got += (r >= 0 && u0 == 0);
#pragma unroll
      for (int v = 0; v < kUnitsPer; ++v) {
        const int u = u0 + v;
        const int64_t col = col0 + u * W;
        if (col >= d) break;
        if (r >= 0) {
          const float* src = vecs + (int64_t)r * d + col;
          if (kVec4) cp_async16(dst + u * W, src);
          else cp_async4(dst + u * W, src);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) dst[u * W + w] = ident;
        }
      }
    }
    return got;
  }
};

// Copy stage j (ids in st[0]) into its ring slot, then move the ids up
// and load those of stage j + 3; returns the participating rows counted.
template <bool kVec4>
__device__ __forceinline__ int32_t issue_next(
    Stage<kVec4> (&st)[3], const int32_t* __restrict__ seg_rows, int32_t n,
    int32_t j, const float* __restrict__ vecs, int64_t d, int64_t col0,
    float* ring, float ident) {
  const int32_t got = st[0].issue(vecs, d, col0,
                                  ring + (j % kStages) * kStageFloats, ident);
  cp_async_commit();
  st[0] = st[1];
  st[1] = st[2];
  st[2].load_ids(seg_rows, n, (j + 3) * kStageRows);
  return got;
}

// Fold m rows of one column of a ring stage in order; a full stage reads
// its values kBatch rows ahead of the adds, so only the chain is serial.
template <bool kIsMax>
__device__ __forceinline__ float fold_stage(float acc, const float* col,
                                            int32_t m) {
  constexpr int kBatch = 16;
  if (m == kStageRows) {
    float cur[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) cur[i] = col[i * kTileCols];
#pragma unroll
    for (int g = 0; g < kStageRows / kBatch; ++g) {
      float nxt[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        nxt[i] = g + 1 < kStageRows / kBatch
                     ? col[((g + 1) * kBatch + i) * kTileCols] : 0.0f;
        acc = fold1<kIsMax>(acc, cur[i]);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) cur[i] = nxt[i];
    }
  } else {
    for (int i = 0; i < m; ++i) acc = fold1<kIsMax>(acc, col[i * kTileCols]);
  }
  return acc;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kCombineThreads)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kCombineThreads)
               : "memory");
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  return __reduce_add_sync(0xffffffffu, v);
}

template <typename T, bool kIsMax>
__global__ void __launch_bounds__(kCombineThreads, 2) combine(
    const float* __restrict__ vecs, int64_t d,
    const int32_t* __restrict__ rows_in, const int32_t* __restrict__ seg_off,
    const int32_t* __restrict__ slots, int64_t n_host, const void* n_dev,
    int dev64, int32_t n_seg, int agg, float* __restrict__ out,
    int32_t* __restrict__ cnt_out, int32_t* __restrict__ ecnt_out) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  __shared__ int32_t red[kWarps];
  constexpr bool kVec4 = sizeof(T) == sizeof(float4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float ident = kIsMax ? -INFINITY : 0.0f;

  // short segments first (their blocks then join the long items)
  const int64_t dv = kVec4 ? d / 4 : d;
  for (int64_t s = blockIdx.x * (int64_t)kWarps + warp; s < n_seg;
       s += (int64_t)gridDim.x * kWarps) {
    const int32_t lo = seg_off[s], hi = seg_off[s + 1];
    if (hi - lo >= kLongMin) continue;
    short_segment<T, kIsMax>(reinterpret_cast<const T*>(vecs), dv, rows_in,
                             lo, hi, agg, s, reinterpret_cast<T*>(out),
                             cnt_out, ecnt_out, lane);
  }

  const int64_t n_live = live_count(n_host, n_dev, dev64);
  const int64_t n_slots = (n_live + kLongMin - 1) / kLongMin;
  const int64_t tiles = (d + kTileCols - 1) / kTileCols;
  for (int64_t it = blockIdx.x; it < n_slots * tiles; it += gridDim.x) {
    const int32_t s = slots[it / tiles];
    if (s < 0) continue;
    const int64_t col0 = (it % tiles) * kTileCols;
    const int32_t a = seg_off[s], n = seg_off[s + 1] - a;
    const int32_t* seg_rows = rows_in + a;
    const int32_t n_stages = (n + kStageRows - 1) / kStageRows;
    int32_t got = 0;
    float acc = ident;
    if (warp < kFolder) {
      // producers: fill stage k once the folder freed it (stage k - kStages),
      // and mark stage k - kStages + 1 landed
      // Stage k is marked full as soon as it lands; the copies of stage
      // k + kStages - kSlack go into the slot of stage k - kSlack once the
      // folder has freed it, so the folder always has kSlack landed stages
      // queued and never waits on this loop's round trip. Row ids ride
      // three stages ahead of their copies.
      Stage<kVec4> st[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) st[j].load_ids(seg_rows, n, j * kStageRows);
#pragma unroll
      for (int32_t j = 0; j < kStages - kSlack; ++j)
        got += issue_next(st, seg_rows, n, j, vecs, d, col0, ring, ident);
      for (int32_t k = 0; k < n_stages; ++k) {
        cp_async_wait<kStages - kSlack - 1>();
        bar_arrive(kFull + k % kStages);
        if (k >= kSlack) bar_sync(kEmpty + (k - kSlack) % kStages);
        got += issue_next(st, seg_rows, n, k + kStages - kSlack, vecs, d,
                          col0, ring, ident);
      }
      cp_async_wait<0>();
      // match the folder's last arrivals, so the barriers start the next
      // item clean
      for (int32_t j = n_stages > kSlack ? n_stages - kSlack : 0;
           j < n_stages; ++j)
        bar_sync(kEmpty + j % kStages);
    } else {
      // the folder: one column per lane, stages in edge order
      for (int32_t k = 0; k < n_stages; ++k) {
        bar_sync(kFull + k % kStages);
        const int32_t m = n - k * kStageRows;
        if (lane < kTileCols) {
          acc = fold_stage<kIsMax>(acc,
                                   ring + (k % kStages) * kStageFloats + lane,
                                   m < kStageRows ? m : kStageRows);
        }
        bar_arrive(kEmpty + k % kStages);
      }
    }
    got = warp_sum(got);
    if (lane == 0) red[warp] = got;
    __syncthreads();
    if (warp == kFolder) {
      const int32_t cnt = warp_sum(lane < kWarps ? red[lane] : 0);
      const int64_t col = col0 + lane;
      if (lane < kTileCols && col < d) out[s * d + col] = fin(acc, agg, cnt);
      if (col0 == 0 && lane == 0) {
        cnt_out[s] = cnt;
        ecnt_out[s] = n;
      }
    }
    __syncthreads();   // the ring and `red` are reused by the next item
  }
}

template <typename T>
void launch_combine(bool is_max, unsigned grid, cudaStream_t st,
                    const float* vecs, int64_t d, const int32_t* rows_in,
                    const int32_t* seg_off, const int32_t* slots,
                    int64_t n_host, const void* n_dev, int dev64,
                    int32_t n_seg, int agg, float* out, int32_t* cnt,
                    int32_t* ecnt) {
  if (is_max) {
    combine<T, true><<<grid, kCombineThreads, kSmemBytes, st>>>(
        vecs, d, rows_in, seg_off, slots, n_host, n_dev, dev64, n_seg, agg,
        out, cnt, ecnt);
  } else {
    combine<T, false><<<grid, kCombineThreads, kSmemBytes, st>>>(
        vecs, d, rows_in, seg_off, slots, n_host, n_dev, dev64, n_seg, agg,
        out, cnt, ecnt);
  }
}

}  // namespace

extern "C" {

// The compile-time plan, for the wrapper to check its own copy against:
// group_edges' and combine's threads, the long-path threshold, tile
// columns, stage rows, stages, and combine's dynamic shared memory.
void dg_segment_combine_config(int32_t* cfg) {
  cfg[0] = kThreads;
  cfg[1] = kCombineThreads;
  cfg[2] = kLongMin;
  cfg[3] = kTileCols;
  cfg[4] = kStageRows;
  cfg[5] = kStages;
  cfg[6] = kSmemBytes;
}

// Allow the combine kernels their dynamic shared memory (above 48 KB);
// called once at load, before any capture.
int dg_segment_combine_init() {
  cudaFuncSetAttribute(combine<float, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  cudaFuncSetAttribute(combine<float, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  cudaFuncSetAttribute(combine<float4, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  cudaFuncSetAttribute(combine<float4, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  return (int)cudaGetLastError();
}

// subj: [rows] int32 sorted unique; vecs: [rows, d] f32 row-major; nbrs:
// [e] int32; keys: [>= n_host] int32, the grouped segment of each slot
// (non-decreasing over the live prefix); order: [n_host] int64 (grouped
// slot j is edge order[j]) or null (identity); the live count is n_host, or
// *n_dev (int32, or int64 when dev64) clamped to [0, n_host]; scratch:
// [n_host + n_seg + 1 + ceil(n_host / kLongMin)] int32 (rows, seg_off,
// slots); out: [n_seg, d] f32; cnt, ecnt: [n_seg] int32. agg: 0 sum, 1 mean,
// 2 max. vec4: d % 4 == 0 and vecs, out 16-byte aligned. Everything on the
// device, launched on `stream`; nothing is synchronised or allocated.
int dg_segment_combine(const void* subj, int64_t rows, const void* vecs,
                       int64_t d, int32_t vec4, const void* nbrs,
                       const void* keys, const void* order, int64_t n_host,
                       const void* n_dev, int32_t dev64, int32_t n_seg,
                       int32_t agg, void* scratch, int32_t group_grid,
                       int32_t combine_grid, void* out, void* cnt, void* ecnt,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* rows_out = static_cast<int32_t*>(scratch);
  int32_t* seg_off = rows_out + n_host;
  int32_t* slots = seg_off + n_seg + 1;
  group_edges<<<(unsigned)group_grid, kThreads, 0, st>>>(
      static_cast<const int32_t*>(subj), rows,
      static_cast<const int32_t*>(nbrs), static_cast<const int32_t*>(keys),
      static_cast<const int64_t*>(order), n_host, n_dev, dev64, n_seg,
      rows_out, seg_off, slots);
  const float* v = static_cast<const float*>(vecs);
  float* o = static_cast<float*>(out);
  int32_t* c = static_cast<int32_t*>(cnt);
  int32_t* ec = static_cast<int32_t*>(ecnt);
  if (vec4) {
    launch_combine<float4>(agg == kMax, (unsigned)combine_grid, st, v, d,
                           rows_out, seg_off, slots, n_host, n_dev, dev64,
                           n_seg, agg, o, c, ec);
  } else {
    launch_combine<float>(agg == kMax, (unsigned)combine_grid, st, v, d,
                          rows_out, seg_off, slots, n_host, n_dev, dev64,
                          n_seg, agg, o, c, ec);
  }
  return (int)cudaGetLastError();
}

const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
