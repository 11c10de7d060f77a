"""Distributed batched bitmap traversal: slab-sharded masks over the mesh.

Port of `dgraph_tpu/parallel/dbfs.py`. B concurrent traversals ride the
lanes of a frontier bitmap `[n_nodes, B]` int8 (`ops/bfs.py`
`bitmap_hop`), and the mesh shards its rows:

  - shard d owns mask rows [d·R, (d+1)·R) AND the COO edges whose src
    lies in that slab (data and its compute together);
  - per hop the gather `frontier[src]` is local (src ranks are
    slab-local); the scatter writes a full-width partial `[N, B]`, and
    one `psum_scatter` folds the partials and hands each shard its slab
    back: the only collective per hop, N·B bytes, whatever the edges.

The partials are int8 lane sums: masks are 0/1, so the sum is at most
the shard count, and a mesh of more than 127 shards is refused rather
than let a lane sum wrap. On one card the D partials are D·N·B bytes at
once (4 × 1,048,576 × 512 ≈ 2.1 GB at the chip check's size). When the
mesh spans processes each process builds its own shards' partials, and
the `psum_scatter` gathers every shard's partial to each process before
it folds them: (D - L)·N·B bytes received per process and hop, L its
own shards.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.ops.bfs import lane_edges, scatter_max_rows
from dgraph_tpu_torch.parallel.mesh import (Mesh, Replicated, Sharded,
                                            count_program, host_np, psum,
                                            psum_scatter, shard)

__all__ = ["shard_coo_by_src", "shard_mask", "unshard_mask",
           "bitmap_recurse_sharded", "MAX_SHARDS"]

# int8 lane sums of 0/1 partials stay exact up to this many shards
MAX_SHARDS = 127


def shard_coo_by_src(indptr: np.ndarray, indices: np.ndarray,
                     n_shards: int):
    """Host-side: CSR → per-shard COO (src slab-LOCAL, dst global),
    padded to a common edge cap. Returns (src_s[D,E], dst_s[D,E],
    deg_s[D,R], rows_per_shard). Padded edge slots point at local row R
    (a zero row the hop appends), so they gather inactive lanes and
    scatter into a dropped slot."""
    n = indptr.shape[0] - 1
    rows = -(-n // n_shards) if n else 1
    deg_all = (indptr[1:] - indptr[:-1]).astype(np.int32)
    srcs, dsts, degs = [], [], []
    e_cap = 1
    for d in range(n_shards):
        lo = min(d * rows, n)
        hi = min(lo + rows, n)
        base, end = int(indptr[lo]), int(indptr[hi])
        deg = np.zeros(rows, np.int32)
        deg[:hi - lo] = deg_all[lo:hi]
        src_l = np.repeat(np.arange(hi - lo, dtype=np.int32),
                          deg_all[lo:hi])
        dst = indices[base:end].astype(np.int32)
        e_cap = max(e_cap, len(dst))
        srcs.append(src_l)
        dsts.append(dst)
        degs.append(deg)
    src_s = np.full((n_shards, e_cap), rows, np.int32)  # pad → zero row
    pad_dst = np.iinfo(np.int32).max                     # dropped slot
    dst_s = np.full((n_shards, e_cap), pad_dst, np.int32)
    for d in range(n_shards):
        src_s[d, :len(srcs[d])] = srcs[d]
        dst_s[d, :len(dsts[d])] = dsts[d]
    return src_s, dst_s, np.stack(degs), rows


def shard_mask(mask: np.ndarray, n_shards: int, rows: int) -> np.ndarray:
    """[N, B] host bitmap → [D, R, B] slab stack (zero-padded rows)."""
    n, b = mask.shape
    out = np.zeros((n_shards, rows, b), np.int8)
    for d in range(n_shards):
        lo = min(d * rows, n)
        hi = min(lo + rows, n)
        out[d, :hi - lo] = mask[lo:hi]
    return out


def unshard_mask(slabs, n_nodes: int) -> np.ndarray:
    """[D, R, B] (host array or `Sharded`) → [N, B]."""
    d, r, b = slabs.shape
    return host_np(slabs).reshape(d * r, b)[:n_nodes]


def _partial(src, dst, frontier, n_pad: int):
    """One shard's full-width partial: frontier rows of its edges' srcs
    scatter-maxed into their global dsts; padded slots (src = the
    appended zero row, dst past the mask) change nothing. Edges whose
    src row holds no bit are left out of the gather and the scatter: a
    zero row changes no maximum."""
    B = frontier.shape[1]
    padded = torch.cat([frontier, frontier.new_zeros((1, B))])
    live = padded.any(1)[src] & (dst < n_pad)
    act = padded[src[live]]
    out = frontier.new_zeros((n_pad, B))
    scatter_max_rows(out, dst[live], act)
    return out


def bitmap_recurse_sharded(mesh: Mesh, src_s, dst_s, deg_s, mask_slabs,
                           depth: int):
    """Depth-bounded loop=false recurse for B queries, slab-sharded.
    Inputs from `shard_coo_by_src` / `shard_mask` (host arrays are
    placed row d on shard d; `Sharded` values stay). Returns `(last[D,R,B],
    seen[D,R,B], edges[B])`: the masks sharded, the per-lane edge counts
    (exact, int32) replicated; un-slab with `unshard_mask`."""
    if mesh.size > MAX_SHARDS:
        raise ValueError(f"int8 lane sums hold at most {MAX_SHARDS} "
                         f"shards, not {mesh.size}")
    count_program("bitmap_recurse_sharded")
    src = [None if p is None else p.long()
           for p in shard(mesh, src_s).parts]
    dst = [None if p is None else p.long()
           for p in shard(mesh, dst_s).parts]
    deg = shard(mesh, deg_s).parts
    mask0 = shard(mesh, mask_slabs).parts
    rows, B = mask0[mesh.lead].shape
    n_pad = rows * mesh.size
    frontier, seen = list(mask0), list(mask0)
    edges = [None if m is None else
             torch.zeros(B, dtype=torch.int32, device=m.device)
             for m in mask0]
    for _h in range(depth):
        hop_edges = psum(mesh, [lane_edges(deg[d], frontier[d])
                                if mesh.is_local(d) else None
                                for d in range(mesh.size)])
        edges = [None if e is None else e + h
                 for e, h in zip(edges, hop_edges)]
        partials = [_partial(src[d], dst[d], frontier[d], n_pad)
                    if mesh.is_local(d) else None
                    for d in range(mesh.size)]
        # fold the partials across shards and land each shard's slab
        summed = psum_scatter(mesh, partials, scatter_dimension=0,
                              tiled=True)
        del partials
        for d in mesh.local:
            nxt = (summed[d] > 0).to(torch.int8)
            fresh = torch.where(seen[d] > 0, 0, nxt).to(torch.int8)
            seen[d] = torch.maximum(seen[d], fresh)
            frontier[d] = fresh
        del summed
    return (Sharded(frontier, mesh), Sharded(seen, mesh),
            Replicated(edges))
