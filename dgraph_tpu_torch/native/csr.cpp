// CSR construction from edge pairs: the bulk-load reduce hot loop.
//
// Reference parity: dgraph/cmd/bulk/reduce.go (sort shard, dedupe, emit
// packed posting lists) — here emit CSR (indptr/indices) over rank space,
// the layout HBM wants (SURVEY §7). Pairs pack into one uint64 so the
// sort is a single std::sort over flat memory.
//
// Built at first use by dgraph_tpu_torch/native/__init__.py (g++).

#include <algorithm>
#include <cstdint>

extern "C" {

// Build CSR from rank pairs (src[i], dst[i]), 0 <= rank < n < 2^31.
// indptr must hold n+1 int32; indices must hold nnz int32 (nnz <= m).
// Returns deduped edge count (nnz), or -1 on bad input.
int64_t dg_build_csr(const int32_t* src, const int32_t* dst, int64_t m,
                     int32_t n, int32_t* indptr, int32_t* indices,
                     uint64_t* scratch /* m u64 */) {
  for (int64_t i = 0; i < m; i++) {
    if (src[i] < 0 || src[i] >= n || dst[i] < 0 || dst[i] >= n) return -1;
    scratch[i] = ((uint64_t)(uint32_t)src[i] << 32) | (uint32_t)dst[i];
  }
  std::sort(scratch, scratch + m);
  int64_t nnz = 0;
  for (int64_t i = 0; i < m; i++) {
    if (i && scratch[i] == scratch[i - 1]) continue;
    scratch[nnz++] = scratch[i];
  }
  for (int32_t r = 0; r <= n; r++) indptr[r] = 0;
  for (int64_t i = 0; i < nnz; i++) {
    indices[i] = (int32_t)(scratch[i] & 0xffffffffu);
    indptr[(scratch[i] >> 32) + 1]++;
  }
  for (int32_t r = 0; r < n; r++) indptr[r + 1] += indptr[r];
  return nnz;
}

}  // extern "C"
