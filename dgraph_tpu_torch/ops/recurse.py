"""Visit-once @recurse hops as fixed-shape torch programs.

Port of `dgraph_tpu/ops/recurse.py`'s `masked_hop` (its
`recurse_frontier` has no caller in either package and is not ported):
each hop is gather → sort-unique → subtraction of the visited set, with
the visited set a dense int8 bitmap over rank space (one gather per
membership test instead of a search of a sorted list). The reference
drops sentinel padding from its bitmap updates with
`.at[uids].set(1, mode="drop")`; here the bitmap has one spare slot at
index `n_nodes` (`n_nodes + 1` bytes) and the padding is sent there, so
an update is one index-put with no host sync and no out-of-range index. `engine/fused.py` runs `masked_hop` as the body of
its recurse stage; nothing here leaves the device or reads a count back.
"""

from __future__ import annotations

import torch

from dgraph_tpu_torch.ops.hop import _take_clip, gather_edges
from dgraph_tpu_torch.ops.uidalgebra import (_member, sentinel,
                                             sort_unique_count, valid_mask)


def seen_bitmap(n_nodes: int, frontier: torch.Tensor) -> torch.Tensor:
    """The int8 visited bitmap ([n_nodes + 1], spare slot last) with the
    real entries of sorted padded `frontier` marked."""
    seen = torch.zeros(n_nodes + 1, dtype=torch.int8, device=frontier.device)
    mark_seen(seen, frontier)
    return seen


def mark_seen(seen: torch.Tensor, uids: torch.Tensor) -> None:
    """Mark the real entries of padded `uids` in `seen`, in place;
    padding lands in the spare slot."""
    spare = seen.shape[0] - 1
    seen.index_fill_(0, torch.where(valid_mask(uids), uids, spare).long(), 1)


def _visited(seen: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
    """`jnp.take(seen, clip(uids, 0, n_nodes - 1), mode="clip") > 0`."""
    return _take_clip(seen[:-1], uids) > 0


def masked_hop(indptr, indices, frontier, allowed, seen_mask,
               edge_cap: int, out_cap: int, use_allowed: bool):
    """One visit-once @recurse hop with the filter fused into the gather
    mask: the per-hop body of the fused recurse stage, which keeps the
    per-hop edge matrix (parents render) and tests membership in the
    filter's allowed set.

    `frontier` is sorted sentinel-padded; `seen_mask` is the int8 bitmap
    of `seen_bitmap`, updated in place. Returns `(nbrs[edge_cap],
    seg[edge_cap], n_kept, nxt[out_cap], n_unique, seen_mask, total)`:
    kept edges compacted to the front in CSR row order, the deduped
    fresh frontier, the bitmap, and the raw gathered edge count
    (`total > edge_cap` or `n_unique > out_cap` ⇒ re-run bigger)."""
    dev = frontier.device
    nbrs, seg, _pos, valid, total = gather_edges(
        indptr, indices, frontier, edge_cap)
    keep = valid
    if use_allowed:
        keep = keep & _member(nbrs, allowed)
    keep = keep & ~_visited(seen_mask, nbrs)
    m_nbrs = torch.where(keep, nbrs, sentinel(nbrs.dtype))
    m_seg = torch.where(keep, seg, 2**31 - 1)
    # compact kept edges to the front keeping CSR row order
    slot_key = torch.where(
        keep, torch.arange(edge_cap, dtype=torch.int32, device=dev),
        edge_cap)
    order = torch.argsort(slot_key, stable=True)
    n_kept = keep.sum(dtype=torch.int32)
    nxt, n_unique = sort_unique_count(m_nbrs, out_cap)
    mark_seen(seen_mask, nxt)
    return (m_nbrs[order], m_seg[order], n_kept, nxt, n_unique,
            seen_mask, total)
