"""shortest(from, to) path queries.

Port of `dgraph_tpu/engine/shortest.py`: iterative frontier expansion
with parent pointers; uniform-cost BFS or facet-weighted relaxation.
`numpaths` returns up to k SIMPLE paths in length order (unweighted:
level-DAG enumeration) or cost order (weighted: Yen's algorithm over the
batched relaxation core). minweight/maxweight bound the paths COUNTED
toward numpaths; unweighted edges weigh 1 for these bounds.

Every hop is the executor's batched CSR expansion (`Executor.expand`),
so a frontier of at least `device_threshold` rows expands on the
device; parent pointers and path reconstruction stay on the host.
Each BFS iteration, relaxation round ("bfs") and Yen iteration ("yen")
is a deadline checkpoint (utils/deadline.py).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.utils import deadline, tracing

MAX_PATH_DEPTH = 32
# Yen's outer loop extracts one path per iteration; bound the total
# when min/maxweight discard most of them
MAX_YEN_ITERS = 128
_EPS = 1e-9


@dataclass
class PathData:
    # each path: list of (rank, pred_sg_index_into_edge_sgs or -1 for start)
    paths: list[list[tuple[int, int]]] = field(default_factory=list)
    edge_sgs: list = field(default_factory=list)
    nodes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # total path cost per path (weighted mode only; rendered as _weight_)
    weights: list[float] = field(default_factory=list)


def shortest_path(ex, sg) -> PathData:
    """BFS from sg.shortest.from_uid to to_uid over the block's edge
    preds. When an edge block names a facet (`friend @facets(weight)`),
    edges relax by that facet's value instead of uniform cost."""
    a = sg.shortest
    with tracing.span("engine.shortest", numpaths=a.numpaths,
                      depth=a.depth) as sp:
        data = _shortest_path(ex, sg)
        sp.attrs["paths"] = len(data.paths)
        sp.attrs["nodes"] = int(len(data.nodes))
        return data


def _shortest_path(ex, sg) -> PathData:
    args = sg.shortest
    store = ex.store
    src = store.rank_of(np.array([args.from_uid], np.int64))[0]
    dst = store.rank_of(np.array([args.to_uid], np.int64))[0]
    data = PathData(edge_sgs=[c for c in sg.children if ex._expands(c)])
    if src < 0 or dst < 0:
        return data
    if any(c.facet_keys for c in data.edge_sgs):
        return _weighted_shortest(ex, sg, data, int(src), int(dst))
    max_depth = args.depth or MAX_PATH_DEPTH
    k = max(1, args.numpaths)
    bounded = args.minweight > float("-inf") or \
        args.maxweight < float("inf")

    if k == 1 and not bounded:
        # fast path: first-visit BFS, one shortest path
        parents: dict[int, list[tuple[int, int]]] = {int(src): []}
        frontier = np.array([src], np.int32)
        found = src == dst
        for _ in range(max_depth):
            if found or not len(frontier):
                break
            # per-BFS-iteration cancellation point (the acceptance
            # granularity for shortest-path budgets)
            deadline.checkpoint("bfs")
            level_new: dict[int, list[tuple[int, int]]] = {}
            for i, esg in enumerate(data.edge_sgs):
                nbrs, seg, pos = ex.expand(esg.attr, esg.is_reverse,
                                           frontier)
                nbrs, seg, pos = ex.filter_edges(esg.filters, nbrs, seg,
                                                 pos)
                for n, s in zip(nbrs.tolist(), seg.tolist()):
                    if n not in parents:  # unseen at earlier levels
                        level_new.setdefault(n, []).append(
                            (int(frontier[s]), i))
            parents.update(level_new)
            if int(dst) in level_new:
                found = True
            frontier = np.array(sorted(level_new), np.int32)

        if int(dst) in parents:
            # iterative walk-back: following the first parent at every
            # step IS the first path the recursive enumeration would yield
            rev, cur = [], int(dst)
            # graftlint: allow(hot-loop-checkpoint): walk-back length is
            # bounded by the BFS depth the checkpointed loop above built
            while True:
                plist = parents[cur]
                if not plist:
                    rev.append((cur, -1))
                    break
                p, pi = plist[0]
                rev.append((cur, pi))
                cur = p
            data.paths = [rev[::-1]]
    else:
        data.paths = _k_shortest(ex, data, int(src), int(dst), max_depth,
                                 k, args.minweight, args.maxweight)
    if data.paths:
        data.nodes = np.unique(np.array([r for p in data.paths for r, _ in p],
                                        np.int32))
    return data


def _k_shortest(ex, data: PathData, src: int, dst: int, max_depth: int,
                k: int, minw: float, maxw: float) -> list:
    """Up to k SIMPLE paths in length order. Unweighted edges weigh 1, so
    a path of h hops costs h; only paths with minw ≤ h ≤ maxw count.
    Level expansion keeps EVERY (parent, pred) edge per level and path
    enumeration interleaves with level construction."""
    out: list = []
    if src == dst:
        # the trivial zero-hop path; cycles back to the source are not
        # simple paths and are never returned
        if minw <= 0 <= maxw:
            out.append([(src, -1)])
        return out

    # levels[l][node] = [(parent, pred_i)] for paths reaching node in
    # exactly l+1 hops
    levels: list[dict[int, list[tuple[int, int]]]] = []

    def walk_back(level: int, rank: int, on_path: frozenset):
        """Simple paths of exactly `level+1` hops ending at rank."""
        for p, pi in levels[level].get(rank, ()):
            if level == 0:
                if p == src:
                    yield [(src, -1), (rank, pi)]
            elif p not in on_path:
                for prefix in walk_back(level - 1, p, on_path | {p}):
                    yield prefix + [(rank, pi)]

    if np.isfinite(maxw):
        max_depth = min(max_depth, max(int(maxw), 0))
    frontier = np.array([src], np.int32)
    for level in range(max_depth):
        if not len(frontier):
            break
        deadline.checkpoint("bfs")
        level_new: dict[int, list[tuple[int, int]]] = {}
        for i, esg in enumerate(data.edge_sgs):
            nbrs, seg, pos = ex.expand(esg.attr, esg.is_reverse, frontier)
            nbrs, seg, pos = ex.filter_edges(esg.filters, nbrs, seg, pos)
            for n, s in zip(nbrs.tolist(), seg.tolist()):
                pair = (int(frontier[s]), i)
                plist = level_new.setdefault(n, [])
                if pair not in plist:
                    plist.append(pair)
        levels.append(level_new)
        frontier = np.array(sorted(level_new), np.int32)
        hops = level + 1
        if minw <= hops <= maxw:
            # src rides the on-path set: a simple path may END at src
            # but never passes THROUGH it
            for path in walk_back(level, dst, frozenset([dst, src])):
                out.append(path)
                if len(out) >= k:
                    return out
    return out[:k]


def _edge_weights(store, ex, esg, nbrs: np.ndarray, pos: np.ndarray,
                  wkey) -> np.ndarray:
    """Facet weights for a batch of edges; edges without the named facet
    (or with a non-numeric value) relax at weight 1, per edge."""
    if not wkey or not len(pos):
        return np.ones(len(nbrs))
    fpos = ex.facet_positions(esg, pos)
    p = store.preds.get(esg.attr)
    col = p.efacets.get(wkey) if p is not None else None
    if col is not None:
        fast = col.numeric_at(np.asarray(fpos, np.int64))
        if fast is not None:
            vals, hit = fast
            return np.where(hit, vals, 1.0)
    fvals = store.edge_facets(esg.attr, fpos, [wkey]).get(wkey)
    if fvals is None:
        return np.ones(len(nbrs))
    arr = np.asarray(fvals)
    if arr.dtype.kind in "ifb":  # homogeneous numeric: vector cast
        return arr.astype(np.float64)
    ws = np.ones(len(fvals))
    for j, v in enumerate(fvals):
        if isinstance(v, (int, float, np.integer, np.floating)):
            ws[j] = float(v)
    return ws


def _weighted_one(ex, data: PathData, src: int, dst: int, wkeys,
                  maxw: float, banned_nodes: frozenset = frozenset(),
                  banned_edges: frozenset = frozenset()):
    """One minimal-cost SIMPLE path src→dst as batched frontier
    relaxation (Bellman-Ford rounds, each expanding the WHOLE improved
    frontier), honoring banned nodes/edges for Yen's spur searches.
    Distances settle first; the path is read back over one tight-edge
    pass (dist[u] + w == dist[v]).

    Returns (cost, path[(rank, pred_i)], pcosts) — pcosts[j] is the
    cumulative cost of path[:j+1] — or (inf, None, None)."""
    store = ex.store
    n = store.n_nodes
    banned_arr = (np.array(sorted(banned_nodes), np.int32)
                  if banned_nodes else None)
    banned_us = {u for u, _, _ in banned_edges}

    def relax_edges(frontier, i, esg):
        # a weighted hop reads edge facets: never the remote route,
        # whose answers carry no edge positions
        nbrs, seg, pos = ex.expand(esg.attr, esg.is_reverse, frontier,
                                   allow_remote=not wkeys[i])
        nbrs, seg, pos = ex.filter_edges(esg.filters, nbrs, seg, pos)
        if not len(nbrs):
            return nbrs, seg, np.zeros(0)
        ws = _edge_weights(store, ex, esg, nbrs, pos, wkeys[i])
        keep = np.ones(len(nbrs), bool)
        if banned_arr is not None:
            keep &= ~np.isin(nbrs, banned_arr)
        if banned_edges:
            srcs = frontier[seg]
            for j in np.nonzero(np.isin(srcs,
                                        list(banned_us)))[0].tolist():
                if (int(srcs[j]), int(nbrs[j]), i) in banned_edges:
                    keep[j] = False
        return nbrs[keep], seg[keep], ws[keep]

    dist = np.full(n, np.inf)
    dist[src] = 0.0
    frontier = np.array([src], np.int32)
    # the round bound guards a (malformed) negative-weight input from
    # looping forever; non-negative graphs exit after ~diameter rounds
    for _round in range(max(n, 1)):
        if not len(frontier):
            break
        deadline.checkpoint("bfs")  # per relaxation round
        nbr_parts, nd_parts = [], []
        for i, esg in enumerate(data.edge_sgs):
            nbrs, seg, ws = relax_edges(frontier, i, esg)
            if not len(nbrs):
                continue
            nd = dist[frontier[seg]] + ws
            # prune relaxations that can neither beat maxweight nor lie
            # on a minimal-cost path to an already-reached dst
            keep = (nd <= maxw) & (nd <= dist[dst] + _EPS)
            if keep.any():
                nbr_parts.append(nbrs[keep])
                nd_parts.append(nd[keep])
        if not nbr_parts:
            break
        all_nbrs = np.concatenate(nbr_parts)
        all_nd = np.concatenate(nd_parts)
        u_nbrs, inv = np.unique(all_nbrs, return_inverse=True)
        best = np.full(len(u_nbrs), np.inf)
        np.minimum.at(best, inv, all_nd)
        improved = best < dist[u_nbrs] - _EPS
        dist[u_nbrs[improved]] = best[improved]
        frontier = u_nbrs[improved].astype(np.int32)

    if not np.isfinite(dist[dst]):
        return np.inf, None, None
    # tight-edge pass: expand every node that can sit on a minimal path
    # (dist ≤ dist[dst]) once, keep edges with dist[u] + w == dist[v]
    parents: dict[int, list[tuple[int, int]]] = {src: []}
    cand = np.nonzero(np.isfinite(dist)
                      & (dist <= dist[dst] + _EPS))[0].astype(np.int32)
    for i, esg in enumerate(data.edge_sgs):
        nbrs, seg, ws = relax_edges(cand, i, esg)
        if not len(nbrs):
            continue
        du = dist[cand[seg]]
        tight = (np.abs(du + ws - dist[nbrs]) <= _EPS) \
            & (dist[nbrs] <= dist[dst] + _EPS) & (nbrs != src)
        for u, v in zip(cand[seg[tight]].tolist(), nbrs[tight].tolist()):
            plist = parents.setdefault(int(v), [])
            if (int(u), i) not in plist:
                plist.append((int(u), i))

    # first SIMPLE path through the tight DAG (zero-weight edges can put
    # cycles in it; the on-path set keeps the walk simple)
    def walk(rank: int, on_path: frozenset):
        plist = parents.get(rank, ())
        if not plist:
            yield [(rank, -1)]
            return
        for p, pi in plist:
            if p in on_path:
                continue
            for prefix in walk(p, on_path | {p}):
                yield prefix + [(rank, pi)]

    path = next(walk(dst, frozenset([dst])), None)
    if path is None:
        return np.inf, None, None
    pcosts = [float(dist[r]) for r, _ in path]
    return float(dist[dst]), path, pcosts


def _weighted_shortest(ex, sg, data: PathData, src: int,
                       dst: int) -> PathData:
    """Facet-weight shortest path(s): Yen's algorithm over the batched
    single-path core. Only paths with minweight ≤ cost ≤ maxweight count
    toward numpaths."""
    args = sg.shortest
    wkeys = [(c.facet_keys[0][1] if c.facet_keys else None)
             for c in data.edge_sgs]
    k = max(1, args.numpaths)

    cost, path, pcosts = _weighted_one(ex, data, src, dst, wkeys,
                                       args.maxweight)
    if path is None:
        return data
    A: list[tuple[float, list, list]] = [(cost, path, pcosts)]
    seen_paths = {tuple(path)}
    B: list[tuple[float, int, list, list]] = []  # (cost, tie, path, pcosts)
    tie = 0

    def in_range(c: float) -> bool:
        return args.minweight <= c <= args.maxweight

    kept = sum(1 for c, _p, _pc in A if in_range(c))
    iters = 0
    while kept < k and iters < MAX_YEN_ITERS:
        deadline.checkpoint("yen")
        iters += 1
        _pc, prev, prev_costs = A[-1]
        for i in range(len(prev) - 1):
            spur = prev[i][0]
            root = prev[:i + 1]
            root_cost = prev_costs[i]
            banned_edges = frozenset(
                (p[i][0], p[i + 1][0], p[i + 1][1])
                for _c, p, _ in A
                if len(p) > i + 1 and p[:i + 1] == root)
            banned_nodes = frozenset(r for r, _ in root[:-1])
            sc, sp, spc = _weighted_one(ex, data, spur, dst, wkeys,
                                        args.maxweight - root_cost,
                                        banned_nodes, banned_edges)
            if sp is None:
                continue
            cand_path = root + sp[1:]
            kk = tuple(cand_path)
            if kk in seen_paths:
                continue
            seen_paths.add(kk)
            cand_pcosts = prev_costs[:i + 1] + \
                [root_cost + c for c in spc[1:]]
            tie += 1
            heapq.heappush(B, (root_cost + sc, tie, cand_path,
                               cand_pcosts))
        if not B:
            break
        c2, _t, p2, pc2 = heapq.heappop(B)
        A.append((c2, p2, pc2))
        if in_range(c2):
            kept += 1

    final = [(c, p) for c, p, _pc in A if in_range(c)][:k]
    data.paths = [p for _c, p in final]
    data.weights = [c for c, _p in final]
    if data.paths:
        data.nodes = np.unique(np.array(
            [r for p in data.paths for r, _ in p], np.int32))
    return data
