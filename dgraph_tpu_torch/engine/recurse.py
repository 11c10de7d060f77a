"""@recurse: iterative whole-frontier re-expansion until fixpoint/depth.

Port of `dgraph_tpu/engine/recurse.py`: `RecurseData`, `split_children`,
the per-query host loop `expand_recurse` (each depth is one batched
expansion per followed predicate over the union frontier, so a large
frontier's hop runs on the device through `Executor.expand`) and
`_bind_recurse_vars`. With `loop: false` a node is expanded at most once
(its first visit); with `loop: true` expansion repeats up to `depth`
regardless of revisits. Each depth is a deadline checkpoint
("recurse"). The mesh routes are ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.engine.ir import SubGraph
from dgraph_tpu_torch.utils import deadline

MAX_RECURSE_DEPTH = 64  # guard when depth: 0 (fixpoint mode)


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

    data = split_children(ex, root.sg, RecurseData(loop=args.loop))
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
            nbrs, seg, pos = ex.expand(esg.attr, esg.is_reverse, frontier)
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
