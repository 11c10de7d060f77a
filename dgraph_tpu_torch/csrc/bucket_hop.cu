// ELL bucket pull-hop for Hopper (sm_90a):  out[r, :] = OR_k frontier[nbr[r, k], :]
// with an optional first-visit epilogue:     fresh = out & ~seen;  seen |= fresh
//
// Replaces dgraph_tpu/ops/pallas_hop.py:bucket_hop_pallas (the repo's only
// Pallas kernel) and, in its fused mode, the `nxt & ~seen` / `seen | fresh`
// update of dgraph_tpu/ops/bfs.py:make_ell_recurse. On the TPU the kernel
// streamed frontier rows through a 16-deep async-DMA ring per block of 256
// output rows. On Hopper the ring's job (many row reads in flight) falls to
// the resident warps, and the design spends its effort on moving fewer
// bytes instead.
//
// What bounds it: bytes. A hop at 4096 lanes (W = 128 words, 512-byte rows)
// gathers random rows of a 537 MB frontier that does not fit in the 50 MB
// L2, so each row read is a DRAM read; the next mask and `seen` are 537 MB
// passes of their own. An OR has no matrix product for the tensor cores and
// the ALU work is ~1 % of the byte time. What the design does about it:
//
//  A. Row-occupancy flags. Every mask a hop reads carries uint8 flags[rows]
//     (1 if the row may have a bit set; 0 only if it is all zero; the
//     sentinel row's flag is 0). The kernel reads flag[nbr[r, k]] (1 MB,
//     stays in L2) and never loads a row flagged 0, so a hop costs the
//     bytes of its occupied rows: 1.6 % of the slots on the bench graph's
//     first hop, 95 % on its fourth. Every launch writes the flags of the
//     rows it writes by a warp vote at the store; each row has one writer.
//  B. Fused first-visit epilogue (seen != nullptr). The launch stores
//     fresh = nxt & ~seen instead of nxt, ORs fresh into `seen` in place,
//     and writes fresh's flags. It reads seen only where nxt has bits and
//     writes it only where fresh has bits, so the mask update costs no
//     pass of its own. The frontier must not share memory with `seen` or
//     `out` (other blocks still gather from it): the wrapper checks that.
//  C. Wide rows (a row of W / 4 >= 32 int4 words spans a warp) go warp per
//     row: lane l loads slot index kb + l and its flag, the warp ballots
//     the occupied slots and walks only those, each row with 16-byte loads,
//     four row loads in flight per warp. A bucket of few rows and many
//     slots (the heavy tail's second-level combines, K up to 1024 with a
//     handful of rows) would leave the card idle behind one warp's 1024
//     dependent row reads, so it runs one block per row instead: the
//     block's 8 warps take strided 32-slot groups and OR their partial rows
//     in shared memory before the epilogue. Narrow rows (W / 4 < 32 words,
//     W = 1 on the serving batch) keep one thread per (row, word), a row's
//     words inside one warp so the flag vote needs no atomics.
//
// Around them: the warp and narrow kernels launch one wave of resident
// blocks that walk their rows with a grid stride, so the 30-odd small
// buckets of a hop pay no block launches beyond it.
//
// Which of the three kernels runs follows from (n_b, K, W) alone. One
// launch computes one degree bucket and writes straight into its row slice
// of the caller's output (row offset `out_row0`, which also offsets `seen`
// and `out_flags`). K is a runtime argument. Row addressing is 64-bit:
// (n + 1) * W passes 2^31 on large graphs. Indices are trusted to lie in
// [0, frontier rows): the host layout (ops/bfs.py) is checked once when it
// is placed on the device, not per launch.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// a wide-row bucket with at most kSplitRows rows and K >= kSplitK slots
// runs one block per row (8 warps fill the card at 1024 rows)
constexpr int64_t kSplitRows = 1024;
constexpr int kSplitK = 64;

__device__ __forceinline__ int32_t vor(int32_t a, int32_t b) { return a | b; }
__device__ __forceinline__ int4 vor(int4 a, int4 b) {
  return make_int4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ int32_t vandn(int32_t a, int32_t b) {
  return a & ~b;
}
__device__ __forceinline__ int4 vandn(int4 a, int4 b) {
  return make_int4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ __forceinline__ bool vnz(int32_t a) { return a != 0; }
__device__ __forceinline__ bool vnz(int4 a) {
  return (a.x | a.y | a.z | a.w) != 0;
}

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ int32_t vzero<int32_t>() { return 0; }
template <>
__device__ __forceinline__ int4 vzero<int4>() { return make_int4(0, 0, 0, 0); }

// Store one (row, word) of the result and return what was stored. Plain
// mode (seen == nullptr) stores the gathered OR; fused mode stores
// fresh = acc & ~seen and ORs fresh into seen, touching seen only where
// acc, then fresh, has bits. `off` indexes out and seen alike.
template <typename V>
__device__ __forceinline__ V store_word(V acc, V* __restrict__ out,
                                        V* __restrict__ seen, int64_t off) {
  V v = acc;
  if (seen != nullptr && vnz(acc)) {
    const V s = seen[off];
    v = vandn(acc, s);
    if (vnz(v)) seen[off] = vor(s, v);
  }
  out[off] = v;
  return v;
}

// Lane l's index of slot kb + l of a row (0 past the row's K slots).
__device__ __forceinline__ int32_t slot_index(const int32_t* __restrict__ idx,
                                              int kb, int K, int lane) {
  return kb + lane < K ? __ldg(idx + kb + lane) : 0;
}

// The warp's ballot of the occupied slots among kb .. kb + 31, lane l
// holding slot kb + l's index r (flags == nullptr: every slot counts as
// occupied). Warp-uniform.
__device__ __forceinline__ unsigned occupied(int32_t r, int kb, int K,
                                             const uint8_t* __restrict__ flags,
                                             int lane) {
  const bool f = kb + lane < K && (flags == nullptr || __ldg(flags + r) != 0);
  return __ballot_sync(kFull, f);
}

// acc | OR of the frontier rows named by the set bits of the ballot `m`
// (lane j holds the row index of bit j), at this lane's word c. Four row
// loads in flight per round; every loop bound is warp-uniform.
template <typename V>
__device__ __forceinline__ V gather_set(unsigned m, int32_t r,
                                        const V* __restrict__ frontier,
                                        int64_t wv, int64_t c, bool cv, V acc) {
  while (m) {
    int64_t rr[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ok[u] = m != 0;
      const int j = ok[u] ? __ffs(m) - 1 : 0;
      m &= m - 1;
      rr[u] = __shfl_sync(kFull, r, j);
    }
    V a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = (ok[u] && cv) ? __ldg(frontier + rr[u] * wv + c) : vzero<V>();
    }
    acc = vor(acc, vor(vor(a[0], a[1]), vor(a[2], a[3])));
  }
  return acc;
}

// Narrow rows (wv < 32): 2^lg lanes per row, one (row, word) per thread,
// 32 >> lg rows per warp, so a row never straddles warps.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bucket_hop_narrow(const int32_t* __restrict__ nbr, int64_t n_b, int K,
                  const V* __restrict__ frontier,
                  const uint8_t* __restrict__ flags, int64_t wv, int lg,
                  V* __restrict__ out, uint8_t* __restrict__ out_flags,
                  V* __restrict__ seen) {
  const int lane = threadIdx.x & 31;
  const int sub = lane >> lg;
  const int64_t w = lane & ((1 << lg) - 1);
  const int64_t rows_per_warp = 32 >> lg;
  const int64_t warp0 = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  const unsigned group = lg == 5 ? kFull : ((1u << (1 << lg)) - 1u);
  for (int64_t wb = warp0; wb * rows_per_warp < n_b; wb += nwarps) {
    const int64_t row = wb * rows_per_warp + sub;
    const bool active = row < n_b && w < wv;
    V v = vzero<V>();
    if (active) {
      const int32_t* idx = nbr + row * int64_t(K);
      V acc = vzero<V>();
      int k = 0;
      for (; k + 4 <= K; k += 4) {
        const int64_t r0 = __ldg(idx + k);
        const int64_t r1 = __ldg(idx + k + 1);
        const int64_t r2 = __ldg(idx + k + 2);
        const int64_t r3 = __ldg(idx + k + 3);
        const bool f0 = flags == nullptr || __ldg(flags + r0) != 0;
        const bool f1 = flags == nullptr || __ldg(flags + r1) != 0;
        const bool f2 = flags == nullptr || __ldg(flags + r2) != 0;
        const bool f3 = flags == nullptr || __ldg(flags + r3) != 0;
        const V a = f0 ? __ldg(frontier + r0 * wv + w) : vzero<V>();
        const V b = f1 ? __ldg(frontier + r1 * wv + w) : vzero<V>();
        const V c = f2 ? __ldg(frontier + r2 * wv + w) : vzero<V>();
        const V d = f3 ? __ldg(frontier + r3 * wv + w) : vzero<V>();
        acc = vor(acc, vor(vor(a, b), vor(c, d)));
      }
      for (; k < K; ++k) {
        const int64_t r = __ldg(idx + k);
        if (flags == nullptr || __ldg(flags + r) != 0) {
          acc = vor(acc, __ldg(frontier + r * wv + w));
        }
      }
      v = store_word(acc, out, seen, row * wv + w);
    }
    const unsigned b = __ballot_sync(kFull, active && vnz(v));
    if (out_flags != nullptr && active && w == 0) {
      out_flags[row] = ((b >> (sub << lg)) & group) != 0;
    }
  }
}

// Wide rows (wv >= 32): one warp per row, lanes over the row's words in
// chunks of 32; slot indices loaded 32 at a time and walked by ballot.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bucket_hop_warp(const int32_t* __restrict__ nbr, int64_t n_b, int K,
                const V* __restrict__ frontier,
                const uint8_t* __restrict__ flags, int64_t wv,
                V* __restrict__ out, uint8_t* __restrict__ out_flags,
                V* __restrict__ seen) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row = warp0; row < n_b; row += nwarps) {
    const int32_t* idx = nbr + row * int64_t(K);
    bool any = false;
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      const bool cv = c < wv;
      V acc = vzero<V>();
      for (int kb = 0; kb < K; kb += 32) {
        const int32_t r = slot_index(idx, kb, K, lane);
        acc = gather_set(occupied(r, kb, K, flags, lane), r, frontier, wv, c,
                         cv, acc);
      }
      const V v = cv ? store_word(acc, out, seen, row * wv + c) : vzero<V>();
      any |= __any_sync(kFull, vnz(v));
    }
    if (out_flags != nullptr && lane == 0) out_flags[row] = any;
  }
}

// Wide rows, few of them, many slots: one block per row. Warp w takes the
// slot groups w, w + 8, w + 16, ... of 32 slots; the partial rows meet in
// shared memory and warp 0 runs the epilogue.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bucket_hop_split(const int32_t* __restrict__ nbr, int64_t n_b, int K,
                 const V* __restrict__ frontier,
                 const uint8_t* __restrict__ flags, int64_t wv,
                 V* __restrict__ out, uint8_t* __restrict__ out_flags,
                 V* __restrict__ seen) {
  __shared__ V part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t row = blockIdx.x; row < n_b; row += gridDim.x) {
    const int32_t* idx = nbr + row * int64_t(K);
    bool any = false;
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      const bool cv = c < wv;
      V acc = vzero<V>();
      for (int kb = warp * 32; kb < K; kb += kWarps * 32) {
        const int32_t r = slot_index(idx, kb, K, lane);
        acc = gather_set(occupied(r, kb, K, flags, lane), r, frontier, wv, c,
                         cv, acc);
      }
      part[warp][lane] = acc;
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int i = 1; i < kWarps; ++i) acc = vor(acc, part[i][lane]);
        const V v = cv ? store_word(acc, out, seen, row * wv + c)
                       : vzero<V>();
        any |= __any_sync(kFull, vnz(v));
      }
      __syncthreads();
    }
    if (out_flags != nullptr && threadIdx.x == 0) out_flags[row] = any;
  }
}

// At most one wave of resident blocks of `kernel` (as many as its
// registers let each SM hold, counted once into `wave`); the kernels walk
// their rows with a grid stride, so a small bucket costs no block
// launches beyond the wave and a large one no second wave.
template <typename Kernel>
int64_t cap_blocks(Kernel kernel, int64_t blocks, int64_t& wave) {
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    wave = int64_t(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks > wave ? wave : blocks;
}

template <typename V>
void launch(const int32_t* nbr, int64_t n_b, int K, const void* frontier,
            const uint8_t* flags, int64_t wv, void* out, uint8_t* out_flags,
            void* seen, cudaStream_t stream) {
  const V* fr = static_cast<const V*>(frontier);
  V* o = static_cast<V*>(out);
  V* sn = static_cast<V*>(seen);
  if (wv >= 32 && K >= kSplitK && n_b <= kSplitRows) {
    bucket_hop_split<V><<<unsigned(n_b), kThreads, 0, stream>>>(
        nbr, n_b, K, fr, flags, wv, o, out_flags, sn);
  } else if (wv >= 32) {
    static int64_t wave = 0;
    const int64_t blocks =
        cap_blocks(bucket_hop_warp<V>, (n_b + kWarps - 1) / kWarps, wave);
    bucket_hop_warp<V><<<unsigned(blocks), kThreads, 0, stream>>>(
        nbr, n_b, K, fr, flags, wv, o, out_flags, sn);
  } else {
    int lg = 0;
    while ((int64_t(1) << lg) < wv) ++lg;
    const int64_t rows_per_warp = 32 >> lg;
    const int64_t warps = (n_b + rows_per_warp - 1) / rows_per_warp;
    static int64_t wave = 0;
    const int64_t blocks =
        cap_blocks(bucket_hop_narrow<V>, (warps + kWarps - 1) / kWarps, wave);
    bucket_hop_narrow<V><<<unsigned(blocks), kThreads, 0, stream>>>(
        nbr, n_b, K, fr, flags, wv, lg, o, out_flags, sn);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// nbr: [n_b, K] int32; frontier: [rows, W] int32; flags: [rows] uint8 or
// null (no row skipped); out, seen: [>= out_row0 + n_b, W] int32, seen null
// for the plain store; out_flags: [>= out_row0 + n_b] uint8 or null. All
// row-major contiguous on the device. Writes out rows (and out_flags, and
// seen where fresh has bits) [out_row0, out_row0 + n_b). n_b == 0
// launches nothing.
int dg_bucket_hop(const void* nbr, int64_t n_b, int32_t K,
                  const void* frontier, const void* flags, int64_t W,
                  void* out, void* out_flags, void* seen, int64_t out_row0,
                  void* stream) {
  if (n_b <= 0) return int(cudaSuccess);
  if (K <= 0 || W <= 0) return int(cudaErrorInvalidValue);
  int32_t* out_rows = static_cast<int32_t*>(out) + out_row0 * W;
  int32_t* seen_rows =
      seen != nullptr ? static_cast<int32_t*>(seen) + out_row0 * W : nullptr;
  uint8_t* oflags = out_flags != nullptr
                        ? static_cast<uint8_t*>(out_flags) + out_row0
                        : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(nbr);
  const uint8_t* fl = static_cast<const uint8_t*>(flags);
  const bool vec4 = (W % 4 == 0) && aligned16(frontier) &&
                    aligned16(out_rows) &&
                    (seen_rows == nullptr || aligned16(seen_rows));
  if (vec4) {
    launch<int4>(idx, n_b, K, frontier, fl, W / 4, out_rows, oflags,
                 seen_rows, s);
  } else {
    launch<int32_t>(idx, n_b, K, frontier, fl, W, out_rows, oflags,
                    seen_rows, s);
  }
  return int(cudaGetLastError());
}

const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
