// ELL pull-hop for Hopper (sm_90a):  out[r, :] = OR_k frontier[nbr[r, k], :]
// with an optional first-visit epilogue:     fresh = out & ~seen;  seen |= fresh
//
// Replaces dgraph_tpu/ops/pallas_hop.py:bucket_hop_pallas (the repo's only
// Pallas kernel) and, in its fused mode, the `nxt & ~seen` / `seen | fresh`
// update of dgraph_tpu/ops/bfs.py:make_ell_recurse. On the TPU the kernel
// streamed frontier rows through a 16-deep async-DMA ring per block of 256
// output rows, one call per degree bucket. On Hopper the ring's job (many
// row reads in flight) falls to the resident warps; the design spends its
// effort on moving fewer bytes, on issuing a whole hop from two launches,
// and on keeping a heavy row off one thread's critical path.
//
// What bounds it: bytes, then latency. A hop at 4096 lanes (W = 128 words,
// 512-byte rows) gathers random rows of a 537 MB frontier that does not
// fit in the 50 MB L2, so each row read is a DRAM read; the next mask and
// `seen` are 537 MB passes of their own. An OR has no matrix product for
// the tensor cores and the ALU work is ~1 % of the byte time. At W = 1 (the
// serving batch) a hop moves a few MB, and what is left is the chain of
// dependent reads (slot index -> row flag -> row word) behind each row.
//
//  A. Row-occupancy flags. Every mask a hop reads carries uint8 flags[rows]
//     (1 if the row may have a bit set; 0 only if it is all zero; the
//     sentinel row's flag is 0). The kernel reads flag[nbr[r, k]] (1 MB,
//     stays in L2) and never loads a row flagged 0, so a hop costs the
//     bytes of its occupied rows: 1.6 % of the slots on the bench graph's
//     first hop, 95 % on its fourth. Each row has exactly one writer, which
//     writes its flag by a vote at the store.
//  B. Fused first-visit epilogue (seen != nullptr). The store writes
//     fresh = nxt & ~seen instead of nxt, ORs fresh into `seen` in place,
//     and writes fresh's flags. It reads seen only where nxt has bits and
//     writes it only where fresh has bits, so the mask update costs no
//     pass of its own. The frontier must not share memory with `seen` or
//     `out` (other blocks still gather from it): the wrapper checks that.
//  C. One launch per level (the launch table). A hop of the bench graph is
//     41 degree buckets; launched one by one they cost 41 host calls of
//     30-39 us each (1.2-1.6 ms on an H100 at 700 W, more than hop 1's
//     0.63 ms of device time)
//     and 41 wave tails, 20 of them buckets under 20,000 rows. Now every
//     bucket of a level is one entry of a table that lives on the device
//     (ops/bucket_hop.py builds it once per prepared graph and width), and
//     one launch of `bucket_hop_grouped` runs them all: each block finds
//     its entry by a binary search over the entries' first blocks and runs
//     that entry's body. Level 1 holds the dense classes, the heavy tail's
//     tiles into the partials and every row set to zero (the in-degree-0
//     class, the sentinel row n, the partials' row M); level 2 holds the
//     second-level combines, which read the partials level 1 wrote (stream
//     order between the two launches; nothing in level 1 reads them). A
//     hop is two launches and one host call of the wrapper, and small
//     buckets' blocks run beside large ones' instead of after their tails.
//     A one-bucket call is a one-entry table of the same kernel.
//  D. Bodies, chosen per entry from (n_b, K, wv), wv the row's words of V
//     (int4 when W % 4 == 0 and the masks are 16-byte aligned, else int32):
//     - wide rows (wv >= 32): a warp per row (`warp`): lane l loads slot
//       index kb + l and its flag, the warp ballots the occupied slots and
//       walks only those, each row with 16-byte loads, four row loads in
//       flight. A bucket of at most 1024 rows and K >= 64 slots (the
//       bench's heavy-tail combines) runs a block per row (`split`):
//       the 8 warps take strided 32-slot groups and meet in shared memory.
//     - narrow rows (wv < 32, every serving batch): 2^lg >= wv lanes cover
//       a row's words, G = 32 >> lg slot groups fill a warp. A thread per
//       (row, word) walks the row's slots, four in flight (`narrow`), or
//       the slots go parallel: a warp per row (`narrow_warp`), where group
//       g takes slots g, g + G, ..., reads each slot's flag and loads only
//       the occupied slots' words, four slots in flight, and the groups
//       meet by __reduce_or_sync (int32 words, one lane a row) or by
//       shuffles. Whichever needs fewer rounds of dependent reads once its
//       threads are spread over one wave of the card wins: a warp per row
//       for few rows or many slots, a thread per row for many rows of few
//       slots. From 16 slots a group, for at most 1024 rows, a block per
//       row (`narrow_block`) does the same with 8 warps, which meet in
//       shared memory.
//     - the heaviest rows: a block walks at most 16 slots per slot group
//       (8 x G x 16 slots). A row of more (has_tag's 131,072-slot row on
//       LDBC SF1: 32 blocks at W = 1, 256 at W = 32) is split over parts
//       blocks. Each block leaves its OR of the row in a scratch row,
//       fences, and takes an atomic ticket; the block that takes the last
//       ticket ORs the parts, runs the epilogue, writes the row's flag
//       (the row's one writer) and returns the ticket to 0 for the
//       table's next launch. A wide split row (K > 4096, no bench row)
//       splits the same way, 4096 slots a block.
//     Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/hop_bodies.py,
//     PERF.md §6), four 131,072-slot rows at W = 1 took 11-17 ms with a
//     thread per row, 0.90-0.97 ms with a warp, 0.12-0.13 ms with a block
//     and 0.010 ms with 32 blocks each. The thresholds live in
//     ops/bucket_hop.py (choose_body).
//  E. The grid-stride bodies (narrow, narrow_warp, warp, zero) get at most
//     one wave of blocks per entry (SMs x 8 blocks) and walk their rows
//     with a stride; the block bodies get a block per (row, part).
//
// Row addressing is 64-bit: (n + 1) * W passes 2^31 on large graphs.
// Indices are trusted to lie in [0, source rows): the host layout
// (ops/bfs.py) is checked once when it is placed on the device, not per
// launch. Plain C interface, loaded with ctypes. Returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the most entries one launch table holds (ops/bucket_hop.py MAX_ENTRIES)
constexpr int kMaxEntries = 128;

// entry bodies and destinations, numbered as ops/bucket_hop.py numbers them
constexpr int64_t kZero = 0, kNarrow = 1, kNarrowWarp = 2, kNarrowBlock = 3,
                  kWarp = 4, kSplit = 5;
constexpr int64_t kOut = 0;

// One launch-table entry: twelve int64 fields, in the order of
// ops/bucket_hop.py FIELDS.
struct Entry {
  int64_t idx;       // const int32_t* [n_b, K] slot indices; 0 for zero rows
  int64_t n_b;       // rows
  int64_t K;         // slots per row
  int64_t row0;      // first row written in the destination
  int64_t dst;       // kOut: out (+ out_flags, seen); else the partials
  int64_t body;      // kZero .. kSplit
  int64_t lg;        // narrow bodies: log2 of the lanes per row
  int64_t parts;     // block bodies: blocks per row
  int64_t block0;    // the entry's first block in the launch's grid
  int64_t blocks;    // blocks the entry owns
  int64_t scratch0;  // parts > 1: first scratch row (wv words of V each)
  int64_t ticket0;   // parts > 1: first ticket
};
static_assert(sizeof(Entry) == 12 * sizeof(int64_t), "twelve int64 fields");

template <typename V>
struct Dest {
  V* out;
  uint8_t* flags;
  V* seen;
};

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

// OR of v over the lanes that hold the same word of a narrow row (lanes
// equal in their low lg bits), left in each of them.
__device__ __forceinline__ int32_t group_or(int32_t v, int lg) {
  if (lg == 0) return int32_t(__reduce_or_sync(kFull, unsigned(v)));
  for (int off = 16; off >= (1 << lg); off >>= 1) {
    v |= __shfl_xor_sync(kFull, v, off);
  }
  return v;
}
__device__ __forceinline__ int4 group_or(int4 v, int lg) {
  for (int off = 16; off >= (1 << lg); off >>= 1) {
    v.x |= __shfl_xor_sync(kFull, v.x, off);
    v.y |= __shfl_xor_sync(kFull, v.y, off);
    v.z |= __shfl_xor_sync(kFull, v.z, off);
    v.w |= __shfl_xor_sync(kFull, v.w, off);
  }
  return v;
}

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

// Lane l's index of slot kb + l of a row (0 at or past `hi`).
__device__ __forceinline__ int32_t slot_index(const int32_t* __restrict__ idx,
                                              int kb, int hi, int lane) {
  return kb + lane < hi ? __ldg(idx + kb + lane) : 0;
}

// The warp's ballot of the occupied slots among kb .. kb + 31 below `hi`,
// lane l holding slot kb + l's index r (flags == nullptr: every slot
// counts as occupied). Warp-uniform.
__device__ __forceinline__ unsigned occupied(int32_t r, int kb, int hi,
                                             const uint8_t* __restrict__ flags,
                                             int lane) {
  const bool f = kb + lane < hi && (flags == nullptr || __ldg(flags + r) != 0);
  return __ballot_sync(kFull, f);
}

// acc | OR of the source rows named by the set bits of the ballot `m`
// (lane j holds the row index of bit j), at this lane's word c. Four row
// loads in flight per round; every loop bound is warp-uniform.
template <typename V>
__device__ __forceinline__ V gather_set(unsigned m, int32_t r,
                                        const V* __restrict__ src,
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
      a[u] = (ok[u] && cv) ? __ldg(src + rr[u] * wv + c) : vzero<V>();
    }
    acc = vor(acc, vor(vor(a[0], a[1]), vor(a[2], a[3])));
  }
  return acc;
}

// OR of word w of the occupied source rows among slots k0, k0 + step, ...
// below `hi` of one row: four slots in flight, each slot's flag read
// before its row. Lanes with `wl` false (w past the row's words) read the
// slot indices only.
template <typename V>
__device__ __forceinline__ V gather_slots(const int32_t* __restrict__ idx,
                                          int k0, int hi, int step,
                                          const V* __restrict__ src,
                                          const uint8_t* __restrict__ flags,
                                          int64_t wv, int64_t w, bool wl) {
  V acc = vzero<V>();
  for (int k = k0; k < hi; k += 4 * step) {
    int64_t r[4];
    bool f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k + u * step;
      f[u] = kk < hi;
      r[u] = f[u] ? __ldg(idx + kk) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      f[u] = f[u] && wl && (flags == nullptr || __ldg(flags + r[u]) != 0);
    }
    V a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = f[u] ? __ldg(src + r[u] * wv + w) : vzero<V>();
    }
    acc = vor(acc, vor(vor(a[0], a[1]), vor(a[2], a[3])));
  }
  return acc;
}

__device__ __forceinline__ const int32_t* entry_idx(const Entry& e) {
  return reinterpret_cast<const int32_t*>(e.idx);
}

// The slot range [lo, hi) of part p of a row of K slots split in `parts`
// (32-slot multiples, so warps keep whole slot groups).
__device__ __forceinline__ void part_range(int64_t K, int64_t parts,
                                           int64_t p, int& lo, int& hi) {
  const int64_t chunk = ((K + parts - 1) / parts + 31) & ~int64_t(31);
  const int64_t a = p * chunk;
  lo = int(a < K ? a : K);
  hi = int(a + chunk < K ? a + chunk : K);
}

// A row split over `parts` blocks: every block has left its OR of the row
// in its scratch row; this block takes a ticket. True (block-uniform) for
// the block that takes the last one, which then sees every part's scratch
// row and returns the ticket to 0 for the table's next launch. Called by
// every thread of the block.
__device__ bool last_to_arrive(unsigned* ticket, int64_t parts) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) + 1u == unsigned(parts);
    if (last) {
      atomicExch(ticket, 0u);
      __threadfence();
    }
  }
  __syncthreads();
  return last != 0;
}

// Rows set to zero: the result rows no bucket computes (the in-degree-0
// class, the sentinel) and the partials' zero row. Flags 0, seen untouched.
template <typename V>
__device__ void zero_rows(const Entry& e, int64_t b, int64_t wv,
                          const Dest<V>& d) {
  const int64_t stride = e.blocks * kThreads;
  const int64_t t0 = b * kThreads + threadIdx.x;
  V* o = d.out + e.row0 * wv;
  for (int64_t i = t0; i < e.n_b * wv; i += stride) o[i] = vzero<V>();
  if (d.flags != nullptr) {
    for (int64_t i = t0; i < e.n_b; i += stride) d.flags[e.row0 + i] = 0;
  }
}

// Narrow rows, few slots: 2^lg lanes per row, one (row, word) per thread,
// 32 >> lg rows per warp, so a row never straddles warps.
template <typename V>
__device__ void narrow_rows(const Entry& e, int64_t b,
                            const V* __restrict__ src,
                            const uint8_t* __restrict__ flags, int64_t wv,
                            const Dest<V>& d) {
  const int lg = int(e.lg);
  const int lane = threadIdx.x & 31;
  const int sub = lane >> lg;
  const int64_t w = lane & ((1 << lg) - 1);
  const int64_t rows_per_warp = 32 >> lg;
  const int64_t warp0 = b * kWarps + (threadIdx.x >> 5);
  const int64_t nwarps = e.blocks * kWarps;
  const unsigned group = lg == 5 ? kFull : ((1u << (1 << lg)) - 1u);
  const int32_t* nbr = entry_idx(e);
  const int K = int(e.K);
  for (int64_t wb = warp0; wb * rows_per_warp < e.n_b; wb += nwarps) {
    const int64_t row = wb * rows_per_warp + sub;
    const bool active = row < e.n_b && w < wv;
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
        const V a0 = f0 ? __ldg(src + r0 * wv + w) : vzero<V>();
        const V a1 = f1 ? __ldg(src + r1 * wv + w) : vzero<V>();
        const V a2 = f2 ? __ldg(src + r2 * wv + w) : vzero<V>();
        const V a3 = f3 ? __ldg(src + r3 * wv + w) : vzero<V>();
        acc = vor(acc, vor(vor(a0, a1), vor(a2, a3)));
      }
      for (; k < K; ++k) {
        const int64_t r = __ldg(idx + k);
        if (flags == nullptr || __ldg(flags + r) != 0) {
          acc = vor(acc, __ldg(src + r * wv + w));
        }
      }
      v = store_word(acc, d.out, d.seen, (e.row0 + row) * wv + w);
    }
    const unsigned bal = __ballot_sync(kFull, active && vnz(v));
    if (d.flags != nullptr && active && w == 0) {
      d.flags[e.row0 + row] = ((bal >> (sub << lg)) & group) != 0;
    }
  }
}

// Narrow rows, many slots: a warp per row. Lane (g, w) — slot group
// g = lane >> lg, word w — takes slots g, g + G, ... (G = 32 >> lg); the
// groups meet by group_or and group 0 stores the row.
template <typename V>
__device__ void narrow_warp_rows(const Entry& e, int64_t b,
                                 const V* __restrict__ src,
                                 const uint8_t* __restrict__ flags,
                                 int64_t wv, const Dest<V>& d) {
  const int lg = int(e.lg);
  const int lane = threadIdx.x & 31;
  const int g = lane >> lg;
  const int64_t w = lane & ((1 << lg) - 1);
  const bool wl = w < wv;
  const int G = 32 >> lg;
  const int64_t warp0 = b * kWarps + (threadIdx.x >> 5);
  const int64_t nwarps = e.blocks * kWarps;
  const int32_t* nbr = entry_idx(e);
  const int K = int(e.K);
  for (int64_t row = warp0; row < e.n_b; row += nwarps) {
    V acc = gather_slots(nbr + row * int64_t(K), g, K, G, src, flags, wv, w,
                         wl);
    acc = group_or(acc, lg);
    const bool writer = g == 0 && wl;
    const V v = writer ? store_word(acc, d.out, d.seen,
                                    (e.row0 + row) * wv + w)
                       : vzero<V>();
    const unsigned bal = __ballot_sync(kFull, writer && vnz(v));
    if (d.flags != nullptr && lane == 0) d.flags[e.row0 + row] = bal != 0;
  }
}

// Narrow rows, thousands of slots: a block per (row, part). The block's
// 8 x G slot groups stride over the part's slots; each warp's groups meet
// by group_or, the warps in shared memory. One part: warp 0 stores the
// row. Several: each block leaves its OR in scratch and the last to
// arrive stores the row.
template <typename V>
__device__ void narrow_block_rows(const Entry& e, int64_t b,
                                  const V* __restrict__ src,
                                  const uint8_t* __restrict__ flags,
                                  int64_t wv, const Dest<V>& d,
                                  V (*part)[32], V* scratch,
                                  unsigned* tickets) {
  const int lg = int(e.lg);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> lg;
  const int64_t w = lane & ((1 << lg) - 1);
  const bool wl = w < wv;
  const int G = 32 >> lg;
  const int32_t* nbr = entry_idx(e);
  const int64_t K = e.K;
  for (int64_t t = b; t < e.n_b * e.parts; t += e.blocks) {
    const int64_t row = t / e.parts, p = t % e.parts;
    int lo, hi;
    part_range(K, e.parts, p, lo, hi);
    V acc = gather_slots(nbr + row * K, lo + warp * G + g, hi, kWarps * G,
                         src, flags, wv, w, wl);
    acc = group_or(acc, lg);
    if (g == 0) part[warp][w] = acc;
    __syncthreads();
    if (warp == 0 && g == 0) {
#pragma unroll
      for (int i = 1; i < kWarps; ++i) acc = vor(acc, part[i][w]);
    }
    const int64_t off = (e.row0 + row) * wv + w;
    const int64_t mine = (e.scratch0 + row * e.parts + p) * wv + w;
    bool store = e.parts == 1;
    if (!store && warp == 0 && g == 0 && wl) scratch[mine] = acc;
    __syncthreads();
    if (!store && last_to_arrive(tickets + e.ticket0 + row, e.parts)) {
      store = true;
      if (warp == 0 && g == 0 && wl) {
        acc = vzero<V>();
        const V* s = scratch + (e.scratch0 + row * e.parts) * wv + w;
        for (int64_t q = 0; q < e.parts; ++q) acc = vor(acc, __ldcg(s + q * wv));
      }
    }
    if (store && warp == 0) {
      const bool writer = g == 0 && wl;
      const V v = writer ? store_word(acc, d.out, d.seen, off) : vzero<V>();
      const unsigned bal = __ballot_sync(kFull, writer && vnz(v));
      if (d.flags != nullptr && lane == 0) d.flags[e.row0 + row] = bal != 0;
    }
  }
}

// Wide rows (wv >= 32): one warp per row, lanes over the row's words in
// chunks of 32; slot indices loaded 32 at a time and walked by ballot.
template <typename V>
__device__ void warp_rows(const Entry& e, int64_t b,
                          const V* __restrict__ src,
                          const uint8_t* __restrict__ flags, int64_t wv,
                          const Dest<V>& d) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = b * kWarps + (threadIdx.x >> 5);
  const int64_t nwarps = e.blocks * kWarps;
  const int32_t* nbr = entry_idx(e);
  const int K = int(e.K);
  for (int64_t row = warp0; row < e.n_b; row += nwarps) {
    const int32_t* idx = nbr + row * int64_t(K);
    bool any = false;
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      const bool cv = c < wv;
      V acc = vzero<V>();
      for (int kb = 0; kb < K; kb += 32) {
        const int32_t r = slot_index(idx, kb, K, lane);
        acc = gather_set(occupied(r, kb, K, flags, lane), r, src, wv, c, cv,
                         acc);
      }
      const V v = cv ? store_word(acc, d.out, d.seen, (e.row0 + row) * wv + c)
                     : vzero<V>();
      any |= __any_sync(kFull, vnz(v));
    }
    if (d.flags != nullptr && lane == 0) d.flags[e.row0 + row] = any;
  }
}

// Wide rows, few of them, many slots: a block per (row, part). Warp w
// takes the part's slot groups w, w + 8, w + 16, ... of 32 slots; the
// partial rows meet in shared memory and warp 0 stores the row (one part)
// or leaves the block's OR in scratch for the last block to arrive.
template <typename V>
__device__ void split_rows(const Entry& e, int64_t b,
                           const V* __restrict__ src,
                           const uint8_t* __restrict__ flags, int64_t wv,
                           const Dest<V>& d, V (*part)[32], V* scratch,
                           unsigned* tickets) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t* nbr = entry_idx(e);
  const int64_t K = e.K;
  for (int64_t t = b; t < e.n_b * e.parts; t += e.blocks) {
    const int64_t row = t / e.parts, p = t % e.parts;
    int lo, hi;
    part_range(K, e.parts, p, lo, hi);
    const int32_t* idx = nbr + row * K;
    const int64_t out0 = (e.row0 + row) * wv;
    V* mine = scratch + (e.scratch0 + row * e.parts + p) * wv;
    bool any = false;
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      const bool cv = c < wv;
      V acc = vzero<V>();
      for (int kb = lo + warp * 32; kb < hi; kb += kWarps * 32) {
        const int32_t r = slot_index(idx, kb, hi, lane);
        acc = gather_set(occupied(r, kb, hi, flags, lane), r, src, wv, c, cv,
                         acc);
      }
      part[warp][lane] = acc;
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int i = 1; i < kWarps; ++i) acc = vor(acc, part[i][lane]);
        if (e.parts == 1) {
          const V v = cv ? store_word(acc, d.out, d.seen, out0 + c)
                         : vzero<V>();
          any |= __any_sync(kFull, vnz(v));
        } else if (cv) {
          mine[c] = acc;
        }
      }
      __syncthreads();
    }
    if (e.parts > 1) {
      if (!last_to_arrive(tickets + e.ticket0 + row, e.parts)) continue;
      if (warp == 0) {
        const V* s = scratch + (e.scratch0 + row * e.parts) * wv;
        for (int64_t c0 = 0; c0 < wv; c0 += 32) {
          const int64_t c = c0 + lane;
          const bool cv = c < wv;
          V acc = vzero<V>();
          if (cv) {
            for (int64_t q = 0; q < e.parts; ++q) {
              acc = vor(acc, __ldcg(s + q * wv + c));
            }
          }
          const V v = cv ? store_word(acc, d.out, d.seen, out0 + c)
                         : vzero<V>();
          any |= __any_sync(kFull, vnz(v));
        }
      }
    }
    if (d.flags != nullptr && threadIdx.x == 0) d.flags[e.row0 + row] = any;
  }
}

// One level of a hop: every entry of the launch table. Block i runs the
// entry whose blocks [block0, block0 + blocks) hold i.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bucket_hop_grouped(const Entry* __restrict__ table, int n_entries,
                   const V* __restrict__ src,
                   const uint8_t* __restrict__ src_flags, int64_t wv,
                   V* __restrict__ out, uint8_t* __restrict__ out_flags,
                   V* __restrict__ seen, V* __restrict__ partials,
                   uint8_t* __restrict__ part_flags, V* __restrict__ scratch,
                   unsigned* __restrict__ tickets) {
  __shared__ int64_t first[kMaxEntries];
  __shared__ V part[kWarps][32];
  for (int i = threadIdx.x; i < n_entries; i += kThreads) {
    first[i] = table[i].block0;
  }
  __syncthreads();
  const int64_t blk = blockIdx.x;
  int lo = 0, hi = n_entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Entry e = table[lo];
  const int64_t b = blk - e.block0;
  Dest<V> d;
  if (e.dst == kOut) {
    d.out = out;
    d.flags = out_flags;
    d.seen = seen;
  } else {
    d.out = partials;
    d.flags = part_flags;
    d.seen = nullptr;
  }
  switch (e.body) {
    case kZero:
      zero_rows(e, b, wv, d);
      break;
    case kNarrow:
      narrow_rows(e, b, src, src_flags, wv, d);
      break;
    case kNarrowWarp:
      narrow_warp_rows(e, b, src, src_flags, wv, d);
      break;
    case kNarrowBlock:
      narrow_block_rows(e, b, src, src_flags, wv, d, part, scratch, tickets);
      break;
    case kWarp:
      warp_rows(e, b, src, src_flags, wv, d);
      break;
    case kSplit:
      split_rows(e, b, src, src_flags, wv, d, part, scratch, tickets);
      break;
    default:
      break;
  }
}

template <typename V>
void launch(const void* table, int n_entries, int64_t blocks,
            const void* src, const void* src_flags, int64_t wv, void* out,
            void* out_flags, void* seen, void* partials, void* part_flags,
            void* scratch, void* tickets, cudaStream_t stream) {
  bucket_hop_grouped<V><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const Entry*>(table), n_entries, static_cast<const V*>(src),
      static_cast<const uint8_t*>(src_flags), wv, static_cast<V*>(out),
      static_cast<uint8_t*>(out_flags), static_cast<V*>(seen),
      static_cast<V*>(partials), static_cast<uint8_t*>(part_flags),
      static_cast<V*>(scratch), static_cast<unsigned*>(tickets));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// One level of a hop. table: [n_entries] Entry on the device, whose
// blocks tile [0, blocks); src: [rows, W] int32, src_flags [rows] uint8 or
// null (no row skipped); out, seen: the result and the first-visit carry
// ([>= rows written, W] int32, seen null for the plain store), out_flags
// [>= rows written] uint8 or null; partials [M + 1, W] int32 with
// part_flags [M + 1] uint8 (null when no entry writes them); scratch and
// tickets: the table's split-row scratch (null when no entry splits a
// row). vec4: rows move as int4 words (W % 4 == 0 and every mask 16-byte
// aligned). All row-major contiguous on the device. blocks == 0 launches
// nothing.
int dg_bucket_hop(const void* table, int32_t n_entries, int64_t blocks,
                  const void* src, const void* src_flags, int64_t W,
                  int32_t vec4, void* out, void* out_flags, void* seen,
                  void* partials, void* part_flags, void* scratch,
                  void* tickets, void* stream) {
  if (blocks <= 0) return int(cudaSuccess);
  if (n_entries <= 0 || n_entries > kMaxEntries || W <= 0 ||
      blocks > 0x7fffffff) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    if (W % 4 != 0 || !aligned16(src) || !aligned16(out) ||
        (seen != nullptr && !aligned16(seen)) ||
        (partials != nullptr && !aligned16(partials)) ||
        (scratch != nullptr && !aligned16(scratch))) {
      return int(cudaErrorMisalignedAddress);
    }
    launch<int4>(table, n_entries, blocks, src, src_flags, W / 4, out,
                 out_flags, seen, partials, part_flags, scratch, tickets, s);
  } else {
    launch<int32_t>(table, n_entries, blocks, src, src_flags, W, out,
                    out_flags, seen, partials, part_flags, scratch, tickets,
                    s);
  }
  return int(cudaGetLastError());
}

const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
