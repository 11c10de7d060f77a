// ELL bucket pull-hop for Hopper (sm_90a):  out[r, :] = OR_k frontier[nbr[r, k], :]
//
// Replaces dgraph_tpu/ops/pallas_hop.py:bucket_hop_pallas (the repo's only
// Pallas kernel). On the TPU the kernel streamed frontier rows through a
// 16-deep async-DMA ring per block of 256 output rows. Here every (output
// row, lane word) pair belongs to one thread, with the word index as the
// fast axis, so one warp reads one contiguous 512-byte frontier row at
// W = 128 words (4096 lanes) with 16-byte vector loads when W % 4 == 0.
// The ring's job (keeping many row reads in flight) falls to the 2048
// resident threads per SM plus a 4-way unrolled k loop: each thread issues
// four independent row loads before it ORs them.
//
// What bounds it: the row gathers. A hop at 4096 lanes reads one random
// 512-byte row per ELL slot out of a frontier of (n + 1) * 512 bytes
// (537 MB on the 2^20-node bench graph), which does not fit in the H100's
// 50 MB L2, so every slot costs a DRAM row read. The design's answer is
// to keep the reads coalesced (a warp per row) and many of them in flight;
// staging indices in shared memory and cp.async / TMA row rings are left
// for later work.
//
// One launch computes one degree bucket and writes straight into its row
// slice of the caller's output (row offset `out_row0`), so a hop assembles
// the next mask without concatenation. K is a runtime argument (the widest
// second-level combine on the bench graph has K = 1024). Row addressing is
// 64-bit: (n + 1) * W passes 2^31 on large graphs. Indices are trusted to
// lie in [0, frontier rows): the host layout (ops/bfs.py) is checked once
// when it is placed on the device, not per launch.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;  // grid-stride beyond this

template <typename V>
__device__ __forceinline__ V vor(V a, V b);

template <>
__device__ __forceinline__ int32_t vor<int32_t>(int32_t a, int32_t b) {
  return a | b;
}

template <>
__device__ __forceinline__ int4 vor<int4>(int4 a, int4 b) {
  return make_int4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

template <typename V>
__device__ __forceinline__ V vzero();

template <>
__device__ __forceinline__ int32_t vzero<int32_t>() { return 0; }

template <>
__device__ __forceinline__ int4 vzero<int4>() { return make_int4(0, 0, 0, 0); }

// V is the per-thread word type: int4 (4 lane words, 16-byte loads) or
// int32_t (1 lane word). `wv` is the row width counted in V units.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bucket_hop_kernel(const int32_t* __restrict__ nbr, int64_t n_b, int K,
                  const V* __restrict__ frontier, int64_t wv,
                  V* __restrict__ out) {
  const int64_t total = n_b * wv;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t row = t / wv;
    const int64_t w = t - row * wv;
    const int32_t* idx = nbr + row * int64_t(K);
    V acc = vzero<V>();
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const int64_t r0 = __ldg(idx + k);
      const int64_t r1 = __ldg(idx + k + 1);
      const int64_t r2 = __ldg(idx + k + 2);
      const int64_t r3 = __ldg(idx + k + 3);
      const V a = __ldg(frontier + r0 * wv + w);
      const V b = __ldg(frontier + r1 * wv + w);
      const V c = __ldg(frontier + r2 * wv + w);
      const V d = __ldg(frontier + r3 * wv + w);
      acc = vor(acc, vor(vor(a, b), vor(c, d)));
    }
    for (; k < K; ++k) {
      const int64_t r = __ldg(idx + k);
      acc = vor(acc, __ldg(frontier + r * wv + w));
    }
    out[row * wv + w] = acc;
  }
}

template <typename V>
void launch(const int32_t* nbr, int64_t n_b, int K, const void* frontier,
            int64_t wv, void* out, cudaStream_t stream) {
  const int64_t total = n_b * wv;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bucket_hop_kernel<V><<<unsigned(blocks), kThreads, 0, stream>>>(
      nbr, n_b, K, static_cast<const V*>(frontier), wv,
      static_cast<V*>(out));
}

}  // namespace

extern "C" {

// nbr: [n_b, K] int32; frontier: [rows, W] int32; out: [>= out_row0 + n_b, W]
// int32, all row-major contiguous on the device. Writes out rows
// [out_row0, out_row0 + n_b). n_b == 0 launches nothing.
int dg_bucket_hop(const void* nbr, int64_t n_b, int32_t K,
                  const void* frontier, int64_t W, void* out,
                  int64_t out_row0, void* stream) {
  if (n_b <= 0) return int(cudaSuccess);
  if (K <= 0 || W <= 0) return int(cudaErrorInvalidValue);
  int32_t* out_rows = static_cast<int32_t*>(out) + out_row0 * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(nbr);
  const bool vec4 = (W % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(frontier) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out_rows) % 16 == 0);
  if (vec4) {
    launch<int4>(idx, n_b, K, frontier, W / 4, out_rows, s);
  } else {
    launch<int32_t>(idx, n_b, K, frontier, W, out_rows, s);
  }
  return int(cudaGetLastError());
}

const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
