"""Row-sharded CSR relations: the tablet model recast for a device mesh.

Port of `dgraph_tpu/parallel/pshard.py`. Each predicate direction's CSR
is split by contiguous subject-rank ranges over the mesh's shard axis,
so every shard owns an equal row slab of every predicate and a hop
engages every shard. Layout (D = mesh size, R = ceil(N/D)), on the host
as the reference has it:

    indptr_s  [D, R+1] int32   local exclusive offsets (ghost rows past
                               N repeat the last offset: degree 0)
    indices_s [D, E]   int32   object ranks in GLOBAL rank space,
                               SENTINEL32-padded to the largest shard
    row_lo    [D]      int32   first global row of each shard
    pos_lo    [D]      int64   first edge position of each shard in the
                               unsharded `indices` (facet columns key on
                               local position + pos_lo)

`device_put_rel` places `indptr_s` and `indices_s` as `mesh.Sharded`
values (row d on shard d's device); `row_lo` and `pos_lo` stay host
arrays, read by the programs as per-shard constants. Object ranks stay
global, so a neighbour gather needs no cross-shard translation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dgraph_tpu_torch.ops.uidalgebra import SENTINEL32
from dgraph_tpu_torch.parallel.mesh import Mesh, Sharded, shard
from dgraph_tpu_torch.store.store import EdgeRel

__all__ = ["ShardedRel", "shard_rel", "device_put_rel",
           "assemble_sharded_rel", "shard_frontier"]


@dataclass
class ShardedRel:
    """One predicate direction, row-partitioned over the mesh: host
    arrays from `shard_rel`, `Sharded` tensors from `device_put_rel`."""

    indptr_s: Sharded | np.ndarray     # [D, R+1]
    indices_s: Sharded | np.ndarray    # [D, E]
    row_lo: np.ndarray                 # [D] int32, host
    n_nodes: int
    pos_lo: np.ndarray | None = None   # [D] int64, host

    @property
    def n_shards(self) -> int:
        return int(self.indptr_s.shape[0])

    @property
    def rows_per_shard(self) -> int:
        return int(self.indptr_s.shape[1]) - 1


def shard_rel(rel: EdgeRel, n_shards: int) -> ShardedRel:
    """Split a host CSR into `n_shards` contiguous row slabs."""
    n = rel.indptr.shape[0] - 1
    rows = -(-n // n_shards) if n else 1
    parts_ptr, parts_idx, lows, pos_lows = [], [], [], []
    max_nnz = 0
    for d in range(n_shards):
        lo = min(d * rows, n)
        hi = min(lo + rows, n)
        ptr = rel.indptr[lo:hi + 1].astype(np.int64)
        base = ptr[0] if ptr.size else 0
        pos_lows.append(int(base))
        local = (ptr - base).astype(np.int32)
        # ghost rows (beyond n) repeat the final offset: degree 0
        if hi - lo < rows:
            local = np.concatenate(
                [local, np.full(rows - (hi - lo),
                                local[-1] if local.size else 0, np.int32)])
        idx = rel.indices[base:base + int(local[-1])]
        max_nnz = max(max_nnz, idx.shape[0])
        parts_ptr.append(local)
        parts_idx.append(idx)
        lows.append(lo)
    cap = max(max_nnz, 1)
    indices_s = np.full((n_shards, cap), SENTINEL32, np.int32)
    for d, idx in enumerate(parts_idx):
        indices_s[d, :idx.shape[0]] = idx
    return ShardedRel(
        indptr_s=np.stack(parts_ptr),
        indices_s=indices_s,
        row_lo=np.asarray(lows, np.int32),
        n_nodes=n,
        pos_lo=np.asarray(pos_lows, np.int64),
    )


def device_put_rel(srel: ShardedRel, mesh: Mesh) -> ShardedRel:
    """Place the shard-stacked arrays on the mesh, row d on shard d."""
    return ShardedRel(
        indptr_s=shard(mesh, srel.indptr_s),
        indices_s=shard(mesh, srel.indices_s),
        row_lo=np.asarray(srel.row_lo, np.int32),
        n_nodes=srel.n_nodes,
        pos_lo=srel.pos_lo,
    )


def assemble_sharded_rel(mesh: Mesh, n_nodes: int,
                         local_shards: dict) -> ShardedRel:
    """A placed ShardedRel from per-shard slabs, `local_shards[d] =
    (indptr_local [R+1] int32, indices [nnz_d] int32)`, without the whole
    relation ever materialising. One process holds every shard of its
    mesh; slabs held by other processes (the reference's multi-host
    deployment, with its host-level exchange of capacities and pos_lo)
    are ROADMAP item 10b."""
    D = mesh.size
    if set(local_shards) != set(range(D)):
        raise NotImplementedError(
            f"shards {sorted(set(range(D)) - set(local_shards))} are not "
            f"local: a mesh across processes is ROADMAP item 10b")
    rows = -(-n_nodes // D) if n_nodes else 1
    nnz = np.array([len(local_shards[d][1]) for d in range(D)], np.int64)
    cap = max(int(nnz.max()), 1)
    pos_lo = np.concatenate([[0], np.cumsum(nnz[:-1])]).astype(np.int64)
    row_lo = np.minimum(np.arange(D) * rows, n_nodes).astype(np.int32)
    ptr = np.zeros((D, rows + 1), np.int32)
    idx = np.full((D, cap), SENTINEL32, np.int32)
    for d in range(D):
        ptr[d, :] = local_shards[d][0]
        idx[d, :nnz[d]] = local_shards[d][1]
    return ShardedRel(indptr_s=shard(mesh, ptr), indices_s=shard(mesh, idx),
                      row_lo=row_lo, n_nodes=n_nodes, pos_lo=pos_lo)


def shard_frontier(frontier: np.ndarray, n_shards: int,
                   f_cap: int) -> np.ndarray:
    """Split a frontier into [D, f_cap] sentinel-padded contiguous chunks
    for the ring hops (the ring visits every shard with every chunk, so
    which chunk starts where is arbitrary)."""
    frontier = np.asarray(frontier, np.int32)
    out = np.full((n_shards, f_cap), SENTINEL32, np.int32)
    per = -(-max(len(frontier), 1) // n_shards)
    if per > f_cap:
        raise ValueError(f"frontier chunk {per} exceeds f_cap {f_cap}")
    for d in range(n_shards):
        chunk = frontier[d * per:(d + 1) * per]
        out[d, :len(chunk)] = chunk
    return out
