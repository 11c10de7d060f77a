"""The hop: one query level as one CSR gather over the whole frontier.

Port of `dgraph_tpu/ops/hop.py` as torch ops (the reference runs it as
XLA-jitted JAX; no Pallas kernel is involved):

    frontier ranks → degree gather → cumsum → edge→row map (search of
    the rows' inclusive ends) → neighbour gather → (sort + unique) next
    frontier

Shapes are fixed by `edge_cap` / `out_cap`, with validity masks carrying
the dynamic sizes, exactly as in the reference, so the padded outputs
equal the reference's slot for slot. `jnp.take(mode="clip")` becomes an
explicit clamp; the sentinel never reaches an index.
"""

from __future__ import annotations

import torch

from dgraph_tpu_torch.ops.uidalgebra import (sentinel, sort_unique_count,
                                             valid_mask)


def launch_key(indptr, frontier, edge_cap: int,
               out_cap: int | None = None) -> tuple:
    """The static configuration of a hop launch: CSR height, frontier
    bucket, and the edge/out caps (the reference's compile-cache key)."""
    return (int(indptr.shape[0]), int(frontier.shape[0]),
            int(edge_cap), out_cap)


def _take_clip(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take(a, idx, mode="clip")`."""
    return a[idx.long().clamp(0, a.shape[0] - 1)]


def frontier_degrees(indptr: torch.Tensor,
                     frontier: torch.Tensor) -> torch.Tensor:
    """Out-degree of each frontier rank (0 for padding), int32."""
    valid = valid_mask(frontier)
    f = torch.where(valid, frontier, 0).long()
    deg = _take_clip(indptr, f + 1) - _take_clip(indptr, f)
    return torch.where(valid, deg, 0).to(torch.int32)


def gather_edges(indptr: torch.Tensor, indices: torch.Tensor,
                 frontier: torch.Tensor, edge_cap: int):
    """Expand every frontier node's posting list into flat edge slots →
    (neighbors[edge_cap], seg[edge_cap], edge_pos[edge_cap],
    valid[edge_cap], total):
      - `seg[j]`: the frontier position that produced edge j;
      - `edge_pos[j]`: its absolute position in `indices` (facets);
      - `total`: the true edge count (0-d int32); slots >= total are
        masked, and `total > edge_cap` means re-run with a bigger cap."""
    dev = frontier.device
    deg = frontier_degrees(indptr, frontier)
    ends = torch.cumsum(deg, 0, dtype=torch.int32)        # inclusive
    offsets = ends - deg                                   # exclusive
    total = deg.sum(dtype=torch.int32)

    j = torch.arange(edge_cap, dtype=torch.int32, device=dev)
    # edge j's row: the first row whose inclusive end passes j. The
    # reference scatters row starts and carries them with a running max
    # (lax.cummax); torch.cummax of one long row runs in one thread
    # block on the card, so the equal search is used. Slots past
    # `total` keep the last non-empty row, as the running max does.
    seg = torch.searchsorted(ends, j, right=True)
    last = torch.searchsorted(ends, (total - 1).clamp(min=0).reshape(1),
                              right=True)
    seg = torch.minimum(seg, torch.where(total > 0, last, 0))
    seg = seg.to(torch.int32)
    # edge j's position in `indices`: its row's indptr start plus the
    # within-row offset, one gather of (start - offset) per row
    src_rank = torch.where(valid_mask(frontier), frontier, 0)
    base = _take_clip(indptr, src_rank) - offsets            # [f_cap]
    edge_pos = base[seg.long()] + j
    valid = j < total
    if indices.shape[0]:
        neighbors = _take_clip(indices, edge_pos)
    else:
        neighbors = torch.zeros(edge_cap, dtype=indices.dtype, device=dev)
    neighbors = torch.where(valid, neighbors, sentinel(indices.dtype))
    return neighbors, seg, edge_pos, valid, total


def expand_frontier(indptr: torch.Tensor, indices: torch.Tensor,
                    frontier: torch.Tensor, edge_cap: int, out_cap: int):
    """One full hop: gather all edges, dedupe into the next sorted
    frontier → (nxt, nxt_count, neighbors, seg, edge_pos, valid, total).
    `total > edge_cap` or `nxt_count > out_cap` means the results must
    not be used: re-run at the next bucket size."""
    neighbors, seg, edge_pos, valid, total = gather_edges(
        indptr, indices, frontier, edge_cap)
    nxt, nxt_count = sort_unique_count(neighbors, out_cap)
    return nxt, nxt_count, neighbors, seg, edge_pos, valid, total
