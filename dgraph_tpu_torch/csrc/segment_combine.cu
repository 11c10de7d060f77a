// Segment combine for Hopper (sm_90a): per-segment sum / mean / max of the
// feature rows of each segment's participating edges, in edge order.
//
// Replaces dgraph_tpu/ops/feat.py:segment_combine / combine_edges (XLA in
// the reference, no Pallas kernel): for each live edge slot j, the row of
// rank nbrs[j] in the sorted tablet `subj` (if it has one) is combined into
// segment seg[j]. Outputs out [n_seg, d] f32, cnt [n_seg] (participating
// edges), ecnt [n_seg] (live edges). A segment with no participating edge
// gets a zero row; `mean` is one IEEE division of the sum by the count.
//
// Determinism is the design's point. An f32 scatter-add with atomics sums
// in an order that changes from run to run; this kernel sums each output
// element in edge order, so every run and every CUDA-graph replay gives the
// same bits, equal to numpy's sequential np.add.at / np.maximum.at (the
// host route, dgraph_tpu/engine/feat.py:host_combine) for any float input.
//   1. The wrapper groups the live edges by segment with a STABLE sort (or
//      not at all when the caller's seg is already non-decreasing) and
//      passes `order` and the segment offsets `seg_off` [n_seg + 1].
//   2. resolve_rows: one thread per grouped edge resolves its tablet row
//      by binary search (-1 when the neighbour has none) into `rows_out`.
//   3. combine: one block per segment (grid-stride), threads across the
//      feature columns (float4 when d % 4 == 0). Each thread walks the
//      segment's edges in order, loading eight rows ahead of its adds, so
//      parallelism over d never changes a sum's order. Parallelism over one
//      segment's edges would, so a hub segment is walked by one block.
//
// What bounds it: bytes. Each participating edge reads one d * 4-byte row
// (1,536 bytes at d = 384) and the arithmetic is one add per float; a
// segment's walk is latency-bound when it is long (a hub), which is the
// cost of the fixed order. No float atomics, no allocation, no fast-math.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kResolveThreads = 256;
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMaxGrid = 132 * 16;

enum Agg { kSum = 0, kMean = 1, kMax = 2 };

__global__ void resolve_rows(const int32_t* __restrict__ subj, int64_t rows,
                             const int32_t* __restrict__ nbrs,
                             const int64_t* __restrict__ order,
                             const int32_t* __restrict__ seg_off,
                             int32_t n_seg, int32_t* __restrict__ rows_out) {
  const int64_t live = seg_off[n_seg];
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < live;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = order ? order[j] : j;
    const int32_t nb = nbrs[e];
    // first position with subj[pos] >= nb (searchsorted, side left)
    int64_t lo = 0, hi = rows;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (subj[mid] < nb) lo = mid + 1; else hi = mid;
    }
    rows_out[j] = (lo < rows && subj[lo] == nb) ? (int32_t)lo : -1;
  }
}

__device__ __forceinline__ void set_all(float& a, float v) { a = v; }
__device__ __forceinline__ void set_all(float4& a, float v) {
  a = make_float4(v, v, v, v);
}
__device__ __forceinline__ void add_to(float& a, float b) { a = a + b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x = a.x + b.x; a.y = a.y + b.y; a.z = a.z + b.z; a.w = a.w + b.w;
}
// np.maximum(a, b): a where a >= b or a is NaN, else b
__device__ __forceinline__ float npmax(float a, float b) {
  return (a >= b || isnan(a)) ? a : b;
}
__device__ __forceinline__ void max_to(float& a, float b) { a = npmax(a, b); }
__device__ __forceinline__ void max_to(float4& a, float4 b) {
  a.x = npmax(a.x, b.x); a.y = npmax(a.y, b.y);
  a.z = npmax(a.z, b.z); a.w = npmax(a.w, b.w);
}
__device__ __forceinline__ float fin(float a, int agg, int32_t cnt) {
  if (cnt == 0) return 0.0f;
  return agg == kMean ? __fdiv_rn(a, (float)cnt) : a;
}
__device__ __forceinline__ float4 fin(float4 a, int agg, int32_t cnt) {
  return make_float4(fin(a.x, agg, cnt), fin(a.y, agg, cnt),
                     fin(a.z, agg, cnt), fin(a.w, agg, cnt));
}

template <typename T>
__device__ __forceinline__ void fold(T& acc, const T& v, int agg) {
  if (agg == kMax) max_to(acc, v); else add_to(acc, v);
}

// T = float or float4; dv = columns of T per row. rows_in holds the tablet
// row of each grouped edge (-1: no row), segment s owns [seg_off[s],
// seg_off[s + 1]).
template <typename T>
__global__ void combine(const T* __restrict__ vecs, int64_t dv,
                        const int32_t* __restrict__ rows_in,
                        const int32_t* __restrict__ seg_off, int32_t n_seg,
                        int agg, T* __restrict__ out,
                        int32_t* __restrict__ cnt_out,
                        int32_t* __restrict__ ecnt_out) {
  for (int64_t s = blockIdx.x; s < n_seg; s += gridDim.x) {
    const int32_t lo = seg_off[s], hi = seg_off[s + 1];
    int32_t cnt = 0;
    for (int64_t c = threadIdx.x; c < dv; c += blockDim.x) {
      T acc;
      set_all(acc, agg == kMax ? -INFINITY : 0.0f);
      cnt = 0;
      int32_t j = lo;
      for (; j + kUnroll <= hi; j += kUnroll) {
        int32_t r[kUnroll];
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) r[u] = rows_in[j + u];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r[u] >= 0) v[u] = vecs[(int64_t)r[u] * dv + c];
          else set_all(v[u], 0.0f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r[u] >= 0) { fold(acc, v[u], agg); ++cnt; }
        }
      }
      for (; j < hi; ++j) {
        const int32_t r = rows_in[j];
        if (r >= 0) { fold(acc, vecs[(int64_t)r * dv + c], agg); ++cnt; }
      }
      out[s * dv + c] = fin(acc, agg, cnt);
    }
    // thread 0 walks column 0 (dv >= 1), so its count is the segment's
    if (threadIdx.x == 0) {
      cnt_out[s] = cnt;
      ecnt_out[s] = hi - lo;
    }
  }
}

}  // namespace

extern "C" {

// subj: [rows] int32 sorted unique; vecs: [rows, d] f32 row-major; nbrs:
// [e_cap] int32; order: [e_cap] int64 (grouped slot j is edge order[j]) or
// null (identity: seg already non-decreasing); seg_off: [n_seg + 1] int32,
// segment s owns grouped slots [seg_off[s], seg_off[s + 1]) and the live
// edges are the first seg_off[n_seg]; rows_scratch: [e_cap] int32; out:
// [n_seg, d] f32; cnt, ecnt: [n_seg] int32. agg: 0 sum, 1 mean, 2 max.
// vec4: d % 4 == 0 and vecs, out 16-byte aligned. Everything on the device,
// launched on `stream`; nothing is synchronised or allocated.
int dg_segment_combine(const void* subj, int64_t rows, const void* vecs,
                       int64_t d, int32_t vec4, const void* nbrs,
                       const void* order, int64_t e_cap, const void* seg_off,
                       int32_t n_seg, int32_t agg, void* rows_scratch,
                       void* out, void* cnt, void* ecnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e_cap > 0) {
    int64_t blocks = (e_cap + kResolveThreads - 1) / kResolveThreads;
    if (blocks > kMaxGrid) blocks = kMaxGrid;
    resolve_rows<<<(unsigned)blocks, kResolveThreads, 0, st>>>(
        static_cast<const int32_t*>(subj), rows,
        static_cast<const int32_t*>(nbrs),
        static_cast<const int64_t*>(order),
        static_cast<const int32_t*>(seg_off), n_seg,
        static_cast<int32_t*>(rows_scratch));
  }
  if (n_seg > 0) {
    const int64_t dv = vec4 ? d / 4 : d;
    int64_t threads = (dv + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const unsigned grid = (unsigned)(n_seg < kMaxGrid ? n_seg : kMaxGrid);
    const int32_t* rows_in = static_cast<const int32_t*>(rows_scratch);
    const int32_t* off = static_cast<const int32_t*>(seg_off);
    if (vec4) {
      combine<float4><<<grid, (unsigned)threads, 0, st>>>(
          static_cast<const float4*>(vecs), dv, rows_in, off, n_seg, agg,
          static_cast<float4*>(out), static_cast<int32_t*>(cnt),
          static_cast<int32_t*>(ecnt));
    } else {
      combine<float><<<grid, (unsigned)threads, 0, st>>>(
          static_cast<const float*>(vecs), dv, rows_in, off, n_seg, agg,
          static_cast<float*>(out), static_cast<int32_t*>(cnt),
          static_cast<int32_t*>(ecnt));
    }
  }
  return (int)cudaGetLastError();
}

const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
