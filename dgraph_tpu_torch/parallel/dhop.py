"""Distributed hop programs: one query level over the mesh's shards.

Port of `dgraph_tpu/parallel/dhop.py`. The reference writes each program
as one jitted `shard_map`; here each is a plain function that runs its
per-shard body for every shard (a slab of the row-sharded CSR,
`pshard.ShardedRel`) and merges through the collectives of `mesh.py`:

  scatter-gather hop  — frontier replicated; each shard expands the rows
      it owns; `all_gather` + sort-unique give the merged next frontier
      on every shard;
  matrix hop / level  — the same expansion returning each shard's edge
      matrix (and, for the level, its filter and per-row pagination),
      left sharded for the engine to stitch;
  ring hop            — frontier sharded; chunks rotate around the mesh
      (`ppermute`, shard i to shard i+1) while every shard expands the
      resident chunk against its rows, D steps;
  recurse / chain     — depth-bounded visit-once `@recurse`: the whole
      loop in one call, or one call per hop whose replicated outputs are
      the next call's inputs unmoved.

The overflow protocol is the reference's exactly: every program returns
what its caps had to hold (`needs`, `max_shard_edges`, merged counts
inflated by the largest per-shard count) merged by `pmax`, and the
caller re-runs at the next bucket when one exceeds its cap; edge totals
are merged by `psum`. A replicated result is computed once per distinct
device (shards of one card share it). Each program runs inside
`mesh.program`, which counts one call in `mesh.PROGRAM_CALLS`.

When the mesh spans processes each process runs the bodies of its own
shards (`Mesh.local`) and leaves the others' parts None; the merges go
through the same collectives, which then cross processes, and every
program returns the same objects as in one process. A failure inside a
body on one rank is known to every rank at the program's next
collective or its closing round (`parallel/mesh.py`).
"""

from __future__ import annotations

import torch

from dgraph_tpu_torch.ops.hop import gather_edges
from dgraph_tpu_torch.ops.level import filter_paginate
from dgraph_tpu_torch.ops.uidalgebra import (_member, difference_sorted,
                                             sentinel, sort_unique_count,
                                             valid_mask)
from dgraph_tpu_torch.parallel.mesh import (SHARDED, Mesh, Replicated,
                                            Sharded, all_gather, hop_input,
                                            pmax, ppermute, program, psum,
                                            replicate, shard)
from dgraph_tpu_torch.parallel.pshard import ShardedRel

__all__ = ["scatter_gather_hop", "matrix_hop", "matrix_level", "ring_hop",
           "ring_matrix_hop", "recurse_fused", "recurse_fused_matrix",
           "chain_hop"]


def _each(mesh: Mesh, fn, *reps) -> list:
    """`fn` of shard d's operands for every shard d of this process
    (None for the others); shards handed the same tensors (a replicated
    value on one device) share one result."""
    memo: dict = {}
    out: list = [None] * mesh.size
    for d in mesh.local:
        args = tuple(r[d] for r in reps)
        key = tuple(id(a) for a in args)
        if key not in memo:
            memo[key] = fn(*args)
        out[d] = memo[key]
    return out


def _per_shard(mesh: Mesh, fn) -> list:
    """`fn(d)` for every shard d of this process, None for the others."""
    return [fn(d) if mesh.is_local(d) else None for d in range(mesh.size)]


def _unzip(rows: list) -> list:
    """Per-shard tuples of values → one per-shard list per value (None
    where the shard belongs to another process)."""
    k = len(next(r for r in rows if r is not None))
    return [[None if r is None else r[i] for r in rows] for i in range(k)]


def _slabs(rel: ShardedRel) -> tuple:
    return rel.indptr_s.parts, rel.indices_s.parts, [
        int(x) for x in rel.row_lo]


def _local_frontier(indptr, row_lo: int, frontier):
    """The part of a global-rank frontier this shard owns, as local rows
    (other slots become the sentinel)."""
    n_rows = indptr.shape[0] - 1
    mine = (valid_mask(frontier) & (frontier >= row_lo)
            & (frontier < row_lo + n_rows))
    return torch.where(mine, frontier - row_lo, sentinel(frontier.dtype))


def _local_expand_full(indptr, indices, row_lo: int, frontier,
                       edge_cap: int):
    """gather_edges over the rows of `frontier` this shard owns; `seg`
    indexes the GLOBAL frontier (rows of other shards add no edge)."""
    return gather_edges(indptr, indices,
                        _local_frontier(indptr, row_lo, frontier), edge_cap)


def _local_expand(indptr, indices, row_lo: int, frontier, edge_cap: int):
    nbrs, _seg, _pos, _valid, total = _local_expand_full(
        indptr, indices, row_lo, frontier, edge_cap)
    return nbrs, total


def _merge(mesh: Mesh, locals_: list, local_cnts: list, out_cap: int):
    """all_gather the shards' local unions, sort-unique on every shard;
    the count is inflated to the largest per-shard union so a per-shard
    truncation shows even when the merged count sits at out_cap."""
    gathered = all_gather(mesh, locals_)
    top = pmax(mesh, local_cnts)

    def one(g, c):
        merged, count = sort_unique_count(g.reshape(-1), out_cap)
        return merged, torch.maximum(count, c)

    return _unzip(_each(mesh, one, gathered, top))


def scatter_gather_hop(mesh: Mesh, rel: ShardedRel, frontier,
                       edge_cap: int, out_cap: int):
    """One hop with a replicated frontier → `(next_frontier[out_cap],
    n_unique, edges_traversed, max_shard_edges)`, all replicated. Valid
    only if `n_unique <= out_cap` and `max_shard_edges <= edge_cap`;
    otherwise re-run at the next bucket size."""
    with program(mesh, "scatter_gather_hop"):
        fr = replicate(mesh, hop_input(frontier, mesh))
        ptr, idx, lo = _slabs(rel)

        def body(d):
            nbrs, total = _local_expand(ptr[d], idx[d], lo[d], fr.parts[d],
                                        edge_cap)
            local, cnt = sort_unique_count(nbrs, out_cap)
            return local, cnt, total

        locals_, cnts, totals = _unzip(_per_shard(mesh, body))
        total_all = psum(mesh, totals)
        # overflow witnesses survive the reductions: if any shard needed
        # more than edge_cap slots or out_cap uniques, the max carries it
        max_shard = pmax(mesh, totals)
        merged, count = _merge(mesh, locals_, cnts, out_cap)
        return (Replicated(merged), Replicated(count), Replicated(total_all),
                Replicated(max_shard))


def matrix_hop(mesh: Mesh, rel: ShardedRel, frontier, edge_cap: int):
    """One hop that returns each shard's edge matrix: `(nbrs[D,
    edge_cap], seg[D, edge_cap], edge_pos[D, edge_cap], totals[D],
    max_shard_edges)`, the first four sharded. Per shard d the first
    totals[d] slots are its edges in CSR row order; `seg` indexes the
    GLOBAL frontier (each row is owned by one shard, so a stable sort by
    seg rebuilds global row order); `edge_pos` is local (add
    rel.pos_lo[d]). Valid only if max_shard_edges <= edge_cap."""
    with program(mesh, "matrix_hop"):
        fr = replicate(mesh, hop_input(frontier, mesh))
        ptr, idx, lo = _slabs(rel)

        def body(d):
            nbrs, seg, pos, _valid, total = _local_expand_full(
                ptr[d], idx[d], lo[d], fr.parts[d], edge_cap)
            return nbrs, seg, pos, total

        nbrs, seg, pos, totals = _unzip(_per_shard(mesh, body))
        return (Sharded(nbrs, mesh), Sharded(seg, mesh), Sharded(pos, mesh),
                Sharded(totals, mesh), Replicated(pmax(mesh, totals)))


def matrix_level(mesh: Mesh, rel: ShardedRel, frontier, allowed, offset,
                 first, edge_cap: int, use_allowed: bool):
    """The fused level (expand → filter → paginate → compact) on every
    shard: rows partition over shards, so per-row filter and pagination
    are shard-local; `allowed` is replicated. Returns (nbrs[D, edge_cap],
    seg[D, edge_cap], pos[D, edge_cap], kept[D], totals[D],
    max_shard_edges): per shard d the first kept[d] slots are its
    surviving edges in CSR row order; seg indexes the GLOBAL frontier;
    pos is local (add rel.pos_lo[d]). Valid only if max_shard_edges <=
    edge_cap."""
    with program(mesh, "matrix_level"):
        fr = replicate(mesh, frontier)
        al = replicate(mesh, allowed)
        ptr, idx, lo = _slabs(rel)
        f_cap = fr.shape[0]

        def body(d):
            nbrs, seg, pos, valid, total = _local_expand_full(
                ptr[d], idx[d], lo[d], fr.parts[d], edge_cap)
            c_nbrs, c_seg, c_pos, n_kept, _ = filter_paginate(
                nbrs, seg, pos, valid, al.parts[d], offset, first, f_cap,
                use_allowed)
            return c_nbrs, c_seg, c_pos, n_kept, total

        nbrs, seg, pos, kept, totals = _unzip(_per_shard(mesh, body))
        return (Sharded(nbrs, mesh), Sharded(seg, mesh), Sharded(pos, mesh),
                Sharded(kept, mesh), Sharded(totals, mesh),
                Replicated(pmax(mesh, totals)))


def _ring(n: int) -> list:
    return [(i, (i + 1) % n) for i in range(n)]


def ring_hop(mesh: Mesh, rel: ShardedRel, frontier_chunks, edge_cap: int,
             out_cap: int):
    """One hop with a SHARDED frontier rotating ring-wise over the mesh.
    `frontier_chunks` is [D, f_cap] (`pshard.shard_frontier`). Returns
    `(local_unions[D, out_cap], merged[out_cap], n_unique, edges,
    max_step_edges)`: the local unions sharded, the rest replicated.
    Valid only if `n_unique <= out_cap` and `max_step_edges <= edge_cap`
    (n_unique is inflated to the largest size any shard's running union
    needed, so a truncation mid-ring shows)."""
    with program(mesh, "ring_hop"):
        chunks = shard(mesh, hop_input(frontier_chunks, mesh, SHARDED)).parts
        ptr, idx, lo = _slabs(rel)
        D = mesh.size
        dt = chunks[mesh.lead].dtype
        acc = _per_shard(mesh, lambda d: torch.full(
            (out_cap,), sentinel(dt), dtype=dt, device=mesh.devices[d]))
        zero = _per_shard(mesh, lambda d: torch.zeros(
            (), dtype=torch.int32, device=mesh.devices[d]))
        total, need, max_step = list(zero), list(zero), list(zero)
        for _i in range(D):
            for d in mesh.local:
                nbrs, t = _local_expand(ptr[d], idx[d], lo[d], chunks[d],
                                        edge_cap)
                # fold this step's neighbours into the running local union,
                # remembering the largest size the union ever needed
                acc[d], cnt = sort_unique_count(torch.cat([acc[d], nbrs]),
                                                out_cap)
                total[d] = total[d] + t
                need[d] = torch.maximum(need[d], cnt)
                max_step[d] = torch.maximum(max_step[d], t)
            chunks = ppermute(mesh, chunks, _ring(D))
        total_all = psum(mesh, total)
        max_edges = pmax(mesh, max_step)
        merged, count = _merge(mesh, acc, need, out_cap)
        return (Sharded(acc, mesh), Replicated(merged), Replicated(count),
                Replicated(total_all), Replicated(max_edges))


def ring_matrix_hop(mesh: Mesh, rel: ShardedRel, frontier_chunks,
                    edge_cap: int):
    """One hop with a SHARDED frontier that returns the edge matrix:
    (nbrs[D, D, edge_cap], seg[D, D, edge_cap], pos[D, D, edge_cap],
    totals[D, D], max_step_edges). For shard d at ring step i the
    expanded chunk started on shard (d - i) mod D; `seg` indexes within
    that chunk; valid only if max_step_edges <= edge_cap."""
    with program(mesh, "ring_matrix_hop"):
        chunks = shard(mesh, frontier_chunks).parts
        ptr, idx, lo = _slabs(rel)
        D = mesh.size
        steps: list = [[] for _ in range(D)]
        max_e = _per_shard(mesh, lambda d: torch.zeros(
            (), dtype=torch.int32, device=mesh.devices[d]))
        for _i in range(D):
            for d in mesh.local:
                nbrs, seg, pos, _valid, t = _local_expand_full(
                    ptr[d], idx[d], lo[d], chunks[d], edge_cap)
                steps[d].append((nbrs, seg, pos, t))
                max_e[d] = torch.maximum(max_e[d], t)
            chunks = ppermute(mesh, chunks, _ring(D))
        out = _unzip(_per_shard(mesh, lambda d: tuple(
            torch.stack(col) for col in zip(*steps[d]))))
        return (Sharded(out[0], mesh), Sharded(out[1], mesh),
                Sharded(out[2], mesh), Sharded(out[3], mesh),
                Replicated(pmax(mesh, max_e)))


def _visit_once(mesh, rel, fr_parts, seen_parts, edge_cap, out_cap,
                seen_cap, capture: bool):
    """One visit-once hop of a replicated frontier against a replicated
    seen set: (fresh, seen2, edges, need_out, need_seen, need_edge) per
    shard, replicated, and each shard's (masked nbrs, masked seg,
    edge_pos, raw edges, kept edges)."""
    ptr, idx, lo = _slabs(rel)

    def body(d):
        fr = fr_parts[d]
        snt = sentinel(fr.dtype)
        nbrs, seg, pos, valid, t = gather_edges(
            ptr[d], idx[d], _local_frontier(ptr[d], lo[d], fr), edge_cap)
        if capture:
            # drop edges to nodes seen BEFORE this hop (edges between two
            # nodes first reached in the same hop are kept: the host
            # loop's first-visit-tree semantics)
            keep = valid & ~_member(nbrs, seen_parts[d])
            nbrs = torch.where(keep, nbrs, snt)
            seg = torch.where(keep, seg, -1)
        else:
            keep = valid
        local, local_cnt = sort_unique_count(nbrs, out_cap)
        return (local, local_cnt, t, nbrs, seg, pos,
                keep.sum(dtype=torch.int32))

    locals_, cnts, ts, m_nbrs, m_seg, m_pos, kept = _unzip(
        _per_shard(mesh, body))
    gathered = all_gather(mesh, locals_)
    top_cnt = pmax(mesh, cnts)
    top_t = pmax(mesh, ts)
    sum_t = psum(mesh, ts)

    def merge(g, seen, c):
        merged, mcnt = sort_unique_count(g.reshape(-1), out_cap)
        fresh = merged if capture else difference_sorted(merged, seen)
        seen2, scnt = sort_unique_count(torch.cat([seen, fresh]), seen_cap)
        return fresh, seen2, torch.maximum(mcnt, c), scnt

    fresh, seen2, need_out, need_seen = _unzip(
        _each(mesh, merge, gathered, seen_parts, top_cnt))
    return (fresh, seen2, sum_t, need_out, need_seen, top_t,
            m_nbrs, m_seg, m_pos, ts, kept)


def _recurse(mesh, rel, frontier, edge_cap, out_cap, seen_cap, depth,
             capture: bool):
    if frontier.shape[0] != out_cap:
        raise ValueError(
            f"frontier buffer {frontier.shape[0]} != out_cap {out_cap}")
    fr = replicate(mesh, frontier).parts

    def start(f):
        seen0, scnt0 = sort_unique_count(f, seen_cap)
        z = torch.zeros((), dtype=torch.int32, device=f.device)
        return seen0, z, z, scnt0, z

    seen, edges, need_out, need_seen, need_edge = _unzip(
        _each(mesh, start, fr))
    ys: list = []
    for _h in range(depth):
        (fresh, seen2, sum_t, n_out, n_seen, top_t, m_nbrs, m_seg, m_pos,
         _ts, _kept) = _visit_once(mesh, rel, fr, seen, edge_cap, out_cap,
                                   seen_cap, capture)
        if capture:
            ys.append((m_nbrs, m_seg, m_pos, fr))

        def fold(e, st, no, ns, ne, a, b, c):
            return (e + st, torch.maximum(no, a), torch.maximum(ns, b),
                    torch.maximum(ne, c))

        edges, need_out, need_seen, need_edge = _unzip(_each(
            mesh, fold, edges, sum_t, need_out, need_seen, need_edge,
            n_out, n_seen, top_t))
        fr, seen = fresh, seen2
    needs = _each(mesh, lambda a, b, c: torch.stack([a, b, c]),
                  need_out, need_seen, need_edge)
    return fr, seen, edges, needs, ys


def recurse_fused(mesh: Mesh, rel: ShardedRel, frontier, edge_cap: int,
                  out_cap: int, seen_cap: int, depth: int):
    """Depth-bounded `@recurse` over one predicate in one call.
    `frontier` must be sorted, sentinel-padded to exactly `out_cap`;
    `seen_cap` bounds the whole reachable set. Returns `(last_frontier,
    seen[seen_cap], edges_traversed, needs[3])`, replicated, where `needs
    = [max frontier slots, max seen slots, max per-shard edge slots]` any
    hop required; valid only if `needs <= [out_cap, seen_cap,
    edge_cap]`, otherwise re-run with the caps `needs` asks for."""
    with program(mesh, "recurse_fused"):
        last, seen, edges, needs, _ = _recurse(
            mesh, rel, frontier, edge_cap, out_cap, seen_cap, depth, False)
        return (Replicated(last), Replicated(seen), Replicated(edges),
                Replicated(needs))


def recurse_fused_matrix(mesh: Mesh, rel: ShardedRel, frontier,
                         edge_cap: int, out_cap: int, seen_cap: int,
                         depth: int):
    """recurse_fused with each hop's edge matrix captured (the engine
    renders every (parent, child) edge): `(last_frontier[out_cap],
    seen[seen_cap], edges, needs[3], nbrs[D, depth, edge_cap], seg[D,
    depth, edge_cap], pos[D, depth, edge_cap], frontiers[depth,
    out_cap])`. For hop h on shard d the slots with nbrs != sentinel are
    surviving (visit-once) edges; seg indexes frontiers[h]; pos +
    rel.pos_lo[d] is the absolute facet position. Same overflow contract
    as recurse_fused."""
    with program(mesh, "recurse_fused_matrix"):
        last, seen, edges, needs, ys = _recurse(
            mesh, rel, frontier, edge_cap, out_cap, seen_cap, depth, True)
        nbrs, seg, pos = _unzip(_per_shard(mesh, lambda d: tuple(
            torch.stack([y[k][d] for y in ys]) for k in range(3))))
        frontiers = _each(mesh, lambda *fs: torch.stack(fs),
                          *[y[3] for y in ys])
        return (Replicated(last), Replicated(seen), Replicated(edges),
                Replicated(needs), Sharded(nbrs, mesh), Sharded(seg, mesh),
                Sharded(pos, mesh), Replicated(frontiers))


def chain_hop(mesh: Mesh, rel: ShardedRel, frontier, seen, edge_cap: int,
              out_cap: int, seen_cap: int):
    """One visit-once hop whose replicated (frontier, seen) outputs are
    exactly the next call's inputs: the reshard-free multi-hop building
    block. `frontier`/`seen` are sorted sentinel-padded buffers of
    exactly `out_cap`/`seen_cap` slots: host numpy on the first hop (the
    seed upload), then the previous call's outputs unmoved. Returns
    `(fresh[out_cap], seen2[seen_cap], edges, needs[3], nbrs[D,
    edge_cap], seg[D, edge_cap], shard_edges[D], kept)`: per shard d the
    slots with nbrs != sentinel are its surviving edges in CSR row
    order, `seg` indexing this hop's input frontier; `shard_edges[d]` is
    the raw edges shard d expanded. Valid only if needs <= [out_cap,
    seen_cap, edge_cap]."""
    with program(mesh, "chain_hop"):
        fr = replicate(mesh, hop_input(frontier, mesh)).parts
        sn = replicate(mesh, hop_input(seen, mesh)).parts
        (fresh, seen2, sum_t, n_out, n_seen, top_t, m_nbrs, m_seg, _pos, ts,
         kept) = _visit_once(mesh, rel, fr, sn, edge_cap, out_cap, seen_cap,
                             True)
        needs = _each(mesh, lambda a, b, c: torch.stack([a, b, c]),
                      n_out, n_seen, top_t)
        return (Replicated(fresh), Replicated(seen2), Replicated(sum_t),
                Replicated(needs), Sharded(m_nbrs, mesh), Sharded(m_seg, mesh),
                Sharded(ts, mesh), Replicated(psum(mesh, kept)))
