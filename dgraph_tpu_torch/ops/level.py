"""The fused level: expand → filter → paginate → dedupe.

Port of `dgraph_tpu/ops/level.py` as torch ops. After the keep-mask
(validity ∧ membership in the filter's allowed set), each edge's
within-row rank among survivors is a segment-local exclusive cumsum;
first/offset become rank-window comparisons, including the negative
`first` (last k) form via per-row survivor totals. The kept edges are
compacted to the front in CSR row order by a stable argsort of slot keys.
Nothing here reads a value back to the host, so the body can be captured
into a CUDA graph (`engine/fused.py`) when `offset` and `first` are 0-d
int32 tensors on the device.
"""

from __future__ import annotations

import torch

from dgraph_tpu_torch.ops.hop import _take_clip, gather_edges
from dgraph_tpu_torch.ops.uidalgebra import (_member, sentinel,
                                             sort_unique_count)

NO_LIMIT = (1 << 30)


def filter_paginate(nbrs, seg, edge_pos, valid, allowed, offset, first,
                    n_rows: int, use_allowed: bool):
    """Filter + paginate + compact one device's gathered edge slots;
    `seg` must be nondecreasing (CSR row order). Returns (nbrs, seg, pos,
    n_kept, masked_nbrs) with kept edges compacted to the front."""
    dev = nbrs.device
    edge_cap = nbrs.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    offset = torch.as_tensor(offset, **i32)
    first = torch.as_tensor(first, **i32)
    keep = valid
    if use_allowed:
        keep = keep & _member(nbrs, allowed)

    k32 = keep.to(torch.int32)
    ksum = torch.cumsum(k32, 0, dtype=torch.int32)
    excl = ksum - k32                             # exclusive at j
    row_ids = torch.arange(n_rows, **i32)
    row_start = torch.searchsorted(seg, row_ids).to(torch.int32)
    row_end = torch.searchsorted(seg, row_ids, right=True).to(torch.int32)
    base_at_row = _take_clip(excl, torch.clamp(row_start, max=edge_cap - 1))
    base_at_row = torch.where(row_start < edge_cap, base_at_row, 0)
    end_ksum = _take_clip(ksum, torch.clamp(row_end - 1, min=0))
    end_ksum = torch.where(row_end > 0, end_ksum, 0)
    row_total = torch.clamp(end_ksum - base_at_row, min=0)

    safe_seg = torch.clamp(seg, 0, n_rows - 1).long()
    rank = excl - base_at_row[safe_seg]           # within-row survivor rank
    lo = offset
    k = torch.where(first == NO_LIMIT, NO_LIMIT, first)
    hi = torch.where(k >= 0, lo + k, NO_LIMIT)
    paged = keep & (rank >= lo) & (rank < hi)
    # negative first: last |k| of the post-offset window
    tail_lo = torch.maximum(row_total[safe_seg] + k, lo)
    paged = torch.where(k < 0, keep & (rank >= tail_lo), paged)

    m_nbrs = torch.where(paged, nbrs, sentinel(nbrs.dtype))
    m_seg = torch.where(paged, seg, 2**31 - 1)
    m_pos = torch.where(paged, edge_pos, 0)
    slot_key = torch.where(paged, torch.arange(edge_cap, **i32), edge_cap)
    order = torch.argsort(slot_key, stable=True)
    n_kept = paged.sum(dtype=torch.int32)
    return m_nbrs[order], m_seg[order], m_pos[order], n_kept, m_nbrs


def expand_level(indptr: torch.Tensor, indices: torch.Tensor,
                 frontier: torch.Tensor, allowed: torch.Tensor, offset,
                 first, edge_cap: int, out_cap: int, use_allowed: bool):
    """One child level, fused.

      frontier   [f_cap] sorted sentinel-padded ranks
      allowed    [a_cap] sorted sentinel-padded filter set (ignored
                 unless use_allowed)
      offset     per-row survivors to skip
      first      >0 keep first k after offset; <0 keep last k;
                 NO_LIMIT = unpaginated

    Returns (nbrs[edge_cap], seg[edge_cap], pos[edge_cap], n_kept,
    next_frontier[out_cap], n_unique, total_edges); valid only if
    total_edges <= edge_cap and n_unique <= out_cap."""
    nbrs, seg, edge_pos, valid, total = gather_edges(
        indptr, indices, frontier, edge_cap)
    c_nbrs, c_seg, c_pos, n_kept, m_nbrs = filter_paginate(
        nbrs, seg, edge_pos, valid, allowed, offset, first,
        frontier.shape[0], use_allowed)
    nxt, n_unique = sort_unique_count(m_nbrs, out_cap)
    return c_nbrs, c_seg, c_pos, n_kept, nxt, n_unique, total
