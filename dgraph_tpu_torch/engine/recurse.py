"""@recurse: iterative whole-frontier re-expansion until fixpoint/depth.

Port of `dgraph_tpu/engine/recurse.py`: `RecurseData`, `split_children`,
the per-query host loop `expand_recurse` (each depth is one batched
expansion per followed predicate over the union frontier, so a large
frontier's hop runs on the device through `Executor.expand`) and
`_bind_recurse_vars`. With `loop: false` a node is expanded at most once
(its first visit); with `loop: true` expansion repeats up to `depth`
regardless of revisits. Each depth is a deadline checkpoint
("recurse").

On a mesh, a depth-bounded visit-once recursion over ONE unfiltered
predicate runs on the shards: by default as `depth` calls of
`parallel/dhop.chain_hop` (`_chain_recurse`, `MESH_CHAIN_HOPS`), whose
replicated frontier and seen set stay on the devices between calls
with `mesh.reshard_guard` armed around the loop, or as one
`recurse_fused_matrix` call (`_fused_recurse`). Each hop is a span
(`mesh.hop`: pred, hop, shards) and charges its shards' modeled µs to
the cost profile's shard sums. Both follow the overflow protocol: a cap
a hop's `needs` exceeds grows to its bucket and the loop runs again.
Every read of a hop's outputs goes through `mesh.host_np`: over a mesh
that spans processes it gathers the other processes' parts, and the
`needs` it reads are replicated, so every rank takes the same re-run.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.engine.ir import SubGraph
from dgraph_tpu_torch.utils import deadline

MAX_RECURSE_DEPTH = 64  # guard when depth: 0 (fixpoint mode)

# Mesh @recurse route: chained hops (one call per hop, frontier and seen
# kept on the devices between calls: the reshard-free serving path) or
# the one-call loop (recurse_fused_matrix). Chain is the serving default;
# the one-call loop stays for comparison and tests.
MESH_CHAIN_HOPS = True


@dataclass
class RecurseData:
    """Per-predicate edge lists accumulated over all depths.

    `edges[pred_key]` = (parents, children) rank arrays; every parent rank
    appears in at most one depth (loop=false), so rows are unambiguous.
    For loop=true, per-depth matrices are kept separate (`by_depth`).
    """

    edge_sgs: list[SubGraph] = field(default_factory=list)
    leaf_sgs: list[SubGraph] = field(default_factory=list)
    # loop=false: one global matrix per predicate
    edges: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    # loop=true: per-depth list of matrices keyed by predicate index
    by_depth: list[dict[int, tuple[np.ndarray, np.ndarray]]] = field(default_factory=list)
    loop: bool = False
    all_nodes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # @msgpass binding (engine/feat.py): rank → f32[d] aggregate over
    # the visit-once edge set; None = unbound (the fused featprop stage
    # binds it inside the program, the staged post-pass on the host)
    feat_vals: dict | None = None
    feat_key: str = ""


def split_children(ex, sg: SubGraph, data: RecurseData) -> RecurseData:
    """Partition a recurse block's children into edge predicates vs
    leaves (one rule for every route)."""
    for c in sg.children:
        (data.edge_sgs if ex._expands(c) else data.leaf_sgs).append(c)
    return data


def expand_recurse(ex, root) -> None:
    """Run the recurse loop below an already-evaluated root LevelNode."""
    sg = root.sg
    args = sg.recurse
    depth = args.depth or MAX_RECURSE_DEPTH
    if args.loop and not args.depth:
        raise ValueError("@recurse(loop: true) requires depth")

    from dgraph_tpu_torch.engine.execute import _needs_facets

    data = split_children(ex, root.sg, RecurseData(loop=args.loop))

    # a single-predicate, unfiltered, depth-bounded visit-once recursion
    # runs on the mesh's shards; filters, facet filters and loop need
    # per-hop host logic and take the loop below
    if (getattr(ex, "mesh", None) is not None and not args.loop
            and args.depth and len(data.edge_sgs) == 1
            and not data.edge_sgs[0].filters
            and not data.edge_sgs[0].facet_filter and len(root.nodes) > 0):
        if MESH_CHAIN_HOPS:
            _chain_recurse(ex, root, data, args.depth)
        else:
            _fused_recurse(ex, root, data, args.depth)
        _bind_recurse_vars(ex, root, data, sg)
        root.recurse_data = data
        return

    frontier = root.nodes
    seen = root.nodes.copy()
    for _d in range(depth):
        if len(frontier) == 0:
            break
        # per-hop cancellation point: a pathological @recurse stops
        # within one hop of its budget (utils/deadline.py)
        deadline.checkpoint("recurse")
        level: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        new_parts = []
        for i, esg in enumerate(data.edge_sgs):
            nbrs, seg, pos = ex.expand(
                esg.attr, esg.is_reverse, frontier,
                allow_remote=not _needs_facets(esg))
            nbrs, seg, pos = ex.filter_edges(esg.filters, nbrs, seg, pos)
            nbrs, seg, pos = ex.facet_filter_edges(esg, esg.attr, nbrs,
                                                   seg, pos)
            if not args.loop and len(nbrs):
                # visit-once: drop edges to already-seen nodes so the
                # result graph is a DAG by depth (first-visit tree)
                keep = ~np.isin(nbrs, seen)
                nbrs, seg = nbrs[keep], seg[keep]
            if not len(nbrs):
                continue
            parents = frontier[seg]
            if data.loop:
                level[i] = (parents, nbrs)
            else:
                if i in data.edges:
                    p0, c0 = data.edges[i]
                    data.edges[i] = (np.concatenate([p0, parents]),
                                     np.concatenate([c0, nbrs]))
                else:
                    data.edges[i] = (parents, nbrs)
            new_parts.append(nbrs)
        if data.loop:
            data.by_depth.append(level)
        if not new_parts:
            break
        nxt = np.unique(np.concatenate(new_parts)).astype(np.int32)
        if not args.loop:
            nxt = np.setdiff1d(nxt, seen).astype(np.int32)
            seen = np.union1d(seen, nxt).astype(np.int32)
        frontier = nxt

    data.all_nodes = seen if not args.loop else np.unique(np.concatenate(
        [root.nodes] + [c for lv in data.by_depth for (_p, c) in lv.values()]
    )).astype(np.int32)
    _bind_recurse_vars(ex, root, data, sg)
    root.recurse_data = data


def _bind_recurse_vars(ex, root, data: RecurseData, sg: SubGraph) -> None:
    """Leaf value vars bind over every visited node; the block's uid var
    is the whole reachable set."""
    for leaf in data.leaf_sgs:
        if leaf.var_name:
            saved_nodes = root.nodes
            root.nodes = data.all_nodes
            ex._record_leaf_vars(leaf, root)
            root.nodes = saved_nodes
    if sg.var_name:
        ex.uid_vars[sg.var_name] = data.all_nodes


def _grow(caps, needs) -> tuple:
    """The (out, seen, edge) caps a hop's needs ask for."""
    from dgraph_tpu_torch.engine.execute import _bucket
    out_cap, seen_cap, edge_cap = caps
    need_out, need_seen, need_edge = needs
    return (_bucket(max(need_out, out_cap)),
            _bucket(max(need_seen, seen_cap), lo=256),
            _bucket(max(need_edge, edge_cap), lo=1024))


def _first_caps(n_seeds: int) -> tuple:
    from dgraph_tpu_torch.engine.execute import _bucket
    out_cap = _bucket(max(n_seeds, 1))
    return out_cap, _bucket(4 * out_cap, lo=256), _bucket(1, lo=1024)


def _chain_recurse(ex, root, data: RecurseData, depth: int) -> None:
    """Depth-bounded mesh @recurse as `depth` calls of one hop program
    (`parallel/dhop.chain_hop`). A hop's replicated (frontier, seen)
    outputs are the next call's inputs unmoved, so nothing re-crosses a
    device boundary between hops (`reshard_guard` armed around the
    loop). The host only reads each hop's edge matrices and input
    frontier for rendering. Semantics are `_fused_recurse`'s and the
    host loop's (visit-once, first-visit tree)."""
    from dgraph_tpu_torch.engine.execute import _host_pad
    from dgraph_tpu_torch.ops.uidalgebra import SENTINEL32
    from dgraph_tpu_torch.parallel.dhop import chain_hop
    from dgraph_tpu_torch.parallel.mesh import host_np, reshard_guard
    from dgraph_tpu_torch.utils import costprofile, tracing
    from dgraph_tpu_torch.utils.metrics import METRICS

    METRICS.inc("mesh_route_total", route="chain")
    esg = data.edge_sgs[0]
    srel = ex.store.sharded_rel(esg.attr, esg.is_reverse, ex.mesh)
    seeds = np.sort(root.nodes).astype(np.int32)
    caps = _first_caps(len(seeds))
    parts_p: list = []
    parts_c: list = []
    seen = None
    traversed = 0
    for _attempt in range(12):  # geometric cap growth, bounded
        out_cap, seen_cap, edge_cap = caps
        fr = _host_pad(seeds, out_cap)
        seen = _host_pad(seeds, seen_cap)
        parts_p, parts_c = [], []
        traversed = 0
        overflowed = False
        with reshard_guard():
            for h in range(depth):
                deadline.checkpoint("recurse")
                with tracing.span("mesh.hop", pred=esg.attr, hop=h,
                                  shards=srel.n_shards) as sp:
                    (fr_next, seen_next, edges, needs, nbrs_s, seg_s,
                     shard_edges, kept) = chain_hop(
                        ex.mesh, srel, fr, seen, edge_cap, out_cap,
                        seen_cap)
                    needs = tuple(int(x) for x in host_np(needs))
                    if (needs[0] > out_cap or needs[1] > seen_cap
                            or needs[2] > edge_cap):
                        caps = _grow(caps, needs)
                        overflowed = True
                        break
                    # render reads: the hop's INPUT frontier maps seg to
                    # parent ranks; the device values feed the next call
                    fr_h = host_np(fr)
                    nbrs_h = host_np(nbrs_s)
                    seg_h = host_np(seg_s)
                    per_shard = host_np(shard_edges)
                    traversed += int(edges)
                    sp.attrs["edges"] = int(kept)
                    for d in range(srel.n_shards):
                        row = nbrs_h[d]
                        m = row != SENTINEL32
                        if m.any():
                            parts_p.append(fr_h[seg_h[d][m]])
                            parts_c.append(row[m])
                        # modeled per-shard µs (the ~16 edges/µs scale
                        # tablets are charged at)
                        if int(per_shard[d]):
                            costprofile.add_shard_cost(
                                d, int(per_shard[d]) // 16 + 1)
                    fr, seen = fr_next, seen_next
                    if needs[0] == 0:  # frontier emptied: fixpoint
                        break
        if not overflowed:
            break
    else:
        raise RuntimeError("recurse caps failed to converge")
    # the edges the hops expanded (before the visit-once filter), as the
    # host loop's expansions count them
    ex.routes.add("mesh_chain", traversed)
    if parts_p:
        data.edges[0] = (np.concatenate(parts_p).astype(np.int32),
                         np.concatenate(parts_c).astype(np.int32))
    seen_h = host_np(seen)
    data.all_nodes = seen_h[seen_h != SENTINEL32].astype(np.int32)


def _fused_recurse(ex, root, data: RecurseData, depth: int) -> None:
    """The whole hop loop as one `parallel/dhop.recurse_fused_matrix`
    call; the host work is the cap policy and the matrices' unpacking."""
    from dgraph_tpu_torch.engine.execute import _host_pad
    from dgraph_tpu_torch.ops.uidalgebra import SENTINEL32
    from dgraph_tpu_torch.parallel.dhop import recurse_fused_matrix
    from dgraph_tpu_torch.parallel.mesh import host_np

    esg = data.edge_sgs[0]
    srel = ex.store.sharded_rel(esg.attr, esg.is_reverse, ex.mesh)
    caps = _first_caps(len(root.nodes))
    for _attempt in range(12):  # geometric cap growth, bounded
        deadline.checkpoint("recurse")
        out_cap, seen_cap, edge_cap = caps
        fr = _host_pad(np.sort(root.nodes).astype(np.int32), out_cap)
        (_last, seen, edges, needs, nbrs_s, seg_s, _pos_s,
         frontiers) = recurse_fused_matrix(
            ex.mesh, srel, fr, edge_cap=edge_cap, out_cap=out_cap,
            seen_cap=seen_cap, depth=depth)
        needs = tuple(int(x) for x in host_np(needs))
        if (needs[0] <= out_cap and needs[1] <= seen_cap
                and needs[2] <= edge_cap):
            break
        caps = _grow(caps, needs)
    else:
        raise RuntimeError("recurse caps failed to converge")

    nbrs_s = host_np(nbrs_s)         # [D, depth, edge_cap]
    seg_s = host_np(seg_s)
    frontiers = host_np(frontiers)   # [depth, out_cap]
    parts_p, parts_c = [], []
    for h in range(depth):
        fr_h = frontiers[h]
        for d in range(nbrs_s.shape[0]):
            row = nbrs_s[d, h]
            m = row != SENTINEL32
            if not m.any():
                continue
            parts_p.append(fr_h[seg_s[d, h][m]])
            parts_c.append(row[m])
    if parts_p:
        data.edges[0] = (np.concatenate(parts_p).astype(np.int32),
                         np.concatenate(parts_c).astype(np.int32))
    ex.routes.add("mesh_chain", int(edges))
    seen = host_np(seen)
    data.all_nodes = seen[seen != SENTINEL32].astype(np.int32)
