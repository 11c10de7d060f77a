"""Lane-batched LEVEL-TREE serving: whole nested queries as one run.

Port of `dgraph_tpu/engine/treebatch.py`. Structurally compatible queries
are packed into the bit-lanes of `ops/bfs.py:make_ell_tree`: every
uid-expansion level of every query is ONE stage of one run over masks
[n+1, W] in the store's global rank space, and every hop of every stage
is the CUDA bucket hop on the card.

What the level tree takes beyond the recurse family of engine/batch.py:
  * multi-level expansion trees (the IC2-IC12 shapes), each tree edge a
    stage;
  * @filter on expansion levels — evaluated once per distinct constant
    per batch to a node set, packed per lane, ANDed on the device;
  * filtered @recurse blocks (the config-3 shape) as scans in the run;
  * multi-block queries: `var` blocks chain stage to stage inside the
    run (uid(v) roots), host-processed blocks consume the bound vars;
  * per-level ordering / pagination / facet keys — applied during the
    host rebuild exactly as the per-query engine applies them.

Division of labour: the device computes every level's NODE SET (the
expansion and filter work, shared by all lanes); the host rebuilds each
query's per-parent edge rows by intersecting the parents' CSR rows with
the level masks (bit tests on the uint32 view, no set algebra), then the
standard renderer emits JSON — so batch results equal the per-query
engine's, as tests/test_torch_treebatch.py asserts.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.engine.execute import (EMPTY64, Executor, LevelNode,
                                             csr_rows, expands)
from dgraph_tpu_torch.engine.ir import FilterNode, SubGraph
from dgraph_tpu_torch.engine.varorder import (_filter_uses, _func_uses,
                                              execution_order)
from dgraph_tpu_torch.utils import costprofile, deadline, tracing
from dgraph_tpu_torch.utils.metrics import METRICS

EMPTY = np.zeros(0, np.int32)

MAX_KERNEL_DEPTH = 64      # recurse stages: device buffers scale with it
MAX_STAGES = 12            # one [n+1, W] mask per stage stays resident

_cache_lock = threading.Lock()


# ---------------------------------------------------------------------------
# plan structures

@dataclass
class StageSpec:
    attr: str
    reverse: bool
    kind: str                  # "hop" | "recurse"
    parent: tuple              # ("seed", slot) | ("stage", idx)
    filt_slot: int | None
    depth: int = 0             # recurse only
    keep_hops: bool = False    # recurse only: rendered block
    path: tuple = ()           # (block_idx,) recurse / (block_idx, i, ...) hop
    filt_shape: tuple | None = None   # structure-only filter canonical


@dataclass
class TreePlan:
    """One kernel group: homogeneous stage structure, per-query params."""

    sig: tuple
    stages: list[StageSpec]
    n_seeds: int
    seed_blocks: list[int]                 # slot s ← block seed_blocks[s]
    filt_paths: list[tuple]                # filt slot → owning stage path
    queries: list = field(default_factory=list)   # per-query parsed blocks


# ---------------------------------------------------------------------------
# planning

_FILTER_FUNCS_BLOCKED = {"uid", "uid_in"}


def _filter_ok(tree: FilterNode | None) -> bool:
    """Filter trees the run can take: evaluable to a node set before
    launch (index lookups only — Executor.filter_set), no complement
    (needs a universe), no var/uid references (bound after launch)."""
    if tree is None:
        return True
    if tree.op == "not":
        return False
    if tree.op == "leaf":
        f = tree.func
        return not (f.name in _FILTER_FUNCS_BLOCKED or f.is_val_var
                    or f.is_count)
    return all(_filter_ok(c) for c in tree.children)


def _filter_shape(tree: FilterNode | None):
    """Structure-only canonical form (constants excluded — they vary per
    query and ride per-lane filter masks)."""
    if tree is None:
        return None
    if tree.op == "leaf":
        f = tree.func
        return ("leaf", f.name, f.attr, f.lang)
    return (tree.op, tuple(_filter_shape(c) for c in tree.children))


def _root_uses_vars(sg: SubGraph) -> bool:
    uses = set()
    if sg.func is not None:
        uses |= _func_uses(sg.func)
    if sg.filters is not None:
        uses |= _filter_uses(sg.filters)
    uses |= {o.attr for o in sg.orders if o.is_val_var}
    return bool(uses)


def _pure_chain_root(sg: SubGraph):
    """uid(v) root with no other root-level processing → the var name,
    else None. Such a block's level sets chain straight off the stage
    that defines v, inside the run."""
    f = sg.func
    if (f is None or f.name != "uid" or f.uids or len(f.args) != 1
            or not isinstance(f.args[0], str)):
        return None
    if (sg.filters is not None or sg.orders or sg.first or sg.offset
            or sg.after):
        return None
    return f.args[0]


def _bad_directives(sg: SubGraph) -> bool:
    # @msgpass blocks are served per query (engine/batch.py:_eligible)
    return bool(sg.groupby or sg.cascade or sg.normalize
                or sg.is_expand_all or sg.shortest is not None
                or sg.msgpass is not None)


class _Ineligible(Exception):
    pass


def plan_tree(store, blocks) -> tuple[tuple, TreePlan] | None:
    """(signature, plan skeleton) when the whole query fits the level-tree
    run, else None. The signature is everything that must match for two
    queries to share a run: the stage DAG (kinds, predicates, directions,
    parentage, filter shapes, recurse depths)."""
    try:
        return _plan_tree(store, blocks)
    except _Ineligible:
        return None


def _plan_tree(store, blocks):
    schema = store.schema
    stages: list[StageSpec] = []
    seed_blocks: list[int] = []
    filt_paths: list[tuple] = []
    var_stage: dict[str, int] = {}
    try:
        order = execution_order(blocks)   # also rejects circular deps
    except ValueError:
        raise _Ineligible from None

    def add_filter(sg: SubGraph, path) -> tuple[int | None, tuple | None]:
        if sg.filters is None:
            return None, None
        if not _filter_ok(sg.filters):
            raise _Ineligible
        filt_paths.append(path)
        return len(filt_paths) - 1, _filter_shape(sg.filters)

    def walk_children(sg: SubGraph, parent_ref, path) -> None:
        child_i = 0
        for c in sg.children:
            if not expands(schema, c):
                continue
            if _bad_directives(c) or c.recurse is not None or c.lang:
                raise _Ineligible
            cpath = (*path, child_i)
            child_i += 1
            slot, fshape = add_filter(c, cpath)
            if len(stages) >= MAX_STAGES:
                raise _Ineligible
            stages.append(StageSpec(
                attr=c.attr, reverse=c.is_reverse, kind="hop",
                parent=parent_ref, filt_slot=slot, path=cpath,
                filt_shape=fshape))
            idx = len(stages) - 1
            if c.var_name:
                var_stage[c.var_name] = idx
            walk_children(c, ("stage", idx), cpath)

    any_stage_block = False
    for bi in order:
        sg = blocks[bi]
        if _bad_directives(sg):
            raise _Ineligible
        edge_children = [c for c in sg.children if expands(schema, c)]
        if sg.recurse is not None:
            r = sg.recurse
            if (r.loop or not r.depth or r.depth > MAX_KERNEL_DEPTH
                    or len(edge_children) != 1):
                raise _Ineligible
            e = edge_children[0]
            if (e.facet_filter is not None or e.facet_keys is not None
                    or e.facet_vars is not None or e.facet_orders
                    or e.first or e.offset or e.after or e.orders
                    or e.children or e.lang):
                raise _Ineligible
            if _root_uses_vars(sg):
                raise _Ineligible
            slot, fshape = add_filter(e, (bi,))
            seed_blocks.append(bi)
            if len(stages) >= MAX_STAGES:
                raise _Ineligible
            # keep_hops always: internal (var) blocks also rebuild their
            # reachable set from the per-hop masks by candidate walks —
            # O(visited edges), never O(n) per lane
            stages.append(StageSpec(
                attr=e.attr, reverse=e.is_reverse, kind="recurse",
                parent=("seed", len(seed_blocks) - 1), filt_slot=slot,
                depth=r.depth, keep_hops=True, path=(bi,),
                filt_shape=fshape))
            # block var = reachable set = the stage's seen mask; an
            # edge-child var inside @recurse binds the same set
            for name in filter(None, (e.var_name, sg.var_name)):
                var_stage[name] = len(stages) - 1
            any_stage_block = True
            continue
        if not edge_children:
            # host-only block (value leaves / aggregations); vars it
            # defines are bound during the per-query run
            continue
        chain_var = _pure_chain_root(sg)
        if chain_var is not None and chain_var in var_stage:
            parent_ref = ("stage", var_stage[chain_var])
        else:
            if _root_uses_vars(sg):
                raise _Ineligible
            seed_blocks.append(bi)
            parent_ref = ("seed", len(seed_blocks) - 1)
        walk_children(sg, parent_ref, (bi,))
        any_stage_block = True

    if not any_stage_block or not stages:
        raise _Ineligible
    sig = (len(seed_blocks), tuple(
        (s.kind, s.attr, s.reverse, s.parent, s.depth, s.keep_hops,
         s.path, s.filt_shape) for s in stages))
    plan = TreePlan(sig=sig, stages=stages, n_seeds=len(seed_blocks),
                    seed_blocks=seed_blocks, filt_paths=filt_paths)
    return sig, plan


class _StageIndex:
    """Maps (path) → per-query SubGraph + stage idx, resolved with the
    schema like the executor resolves children."""

    def __init__(self, store, plan: TreePlan, blocks):
        self.by_path: dict[tuple, int] = {
            s.path: i for i, s in enumerate(plan.stages)}
        self.sg_by_path: dict[tuple, SubGraph] = {}
        schema = store.schema
        for bi, sg in enumerate(blocks):
            if sg.recurse is not None:
                ecs = [c for c in sg.children if expands(schema, c)]
                if len(ecs) == 1 and (bi,) in self.by_path:
                    self.sg_by_path[(bi,)] = ecs[0]
                continue
            self._walk(schema, sg, (bi,))

    def _walk(self, schema, sg, path):
        child_i = 0
        for c in sg.children:
            if not expands(schema, c):
                continue
            cpath = (*path, child_i)
            child_i += 1
            if cpath in self.by_path:
                self.sg_by_path[cpath] = c
                self._walk(schema, c, cpath)


# ---------------------------------------------------------------------------
# execution

def run_tree_batch(store, plan: TreePlan, device, device_threshold: int):
    """Execute one homogeneous group as ONE make_ell_tree run on `device`
    and render each query with the standard engine over mask-constrained
    expansion. Returns one JSON dict per query, or None (the caller
    serves the group per query) for reasons of the query or the data: an
    empty relation, a graph whose size differs from the store's, a root
    evaluation or host rebuild that raises the query's own error, or a
    filter that is not a node set. A kernel build or launch failure, or
    an out-of-memory, raises."""
    from dgraph_tpu_torch.engine.outputnode import to_json

    inputs = _tree_inputs(store, plan, device, device_threshold)
    if inputs is None:
        return None
    rels, seed_lists, filt_lists, idx_per_query, root_displays = inputs
    n = store.n_nodes
    lanes = _lanes(plan)
    B = len(plan.queries)
    # budget gate before the device is committed to the tree run
    deadline.checkpoint("kernel")
    METRICS.inc("kernel_group_launches_total", family="tree")
    METRICS.inc("kernel_group_queries_total", float(B), family="tree")
    METRICS.inc("kernel_padded_lanes_total", float(lanes - B),
                family="tree")
    from dgraph_tpu_torch.engine.batch import _note_kernel_features
    _note_kernel_features("*", "tree", lanes, lanes - B,
                          len(plan.stages), B)
    t_exec = time.perf_counter()
    with tracing.span("batch.tree_run", stages=len(plan.stages),
                      queries=B, lanes=lanes, padded_lanes=lanes - B):
        fn, _descs = _tree_kernel_for(store, plan, rels, n, lanes // 32,
                                      device)
        outs = fn(*_tree_masks(n, lanes, seed_lists, filt_lists, device))
        costprofile.note_launch(t_exec, time.perf_counter())

        # one host copy per stage output; bit tests against these masks
        # rebuild every query's edge rows
        def host(t):
            return t.cpu().numpy().view(np.uint32)

        masks: list = []
        for s, o in zip(plan.stages, outs):
            if s.kind == "recurse" and s.keep_hops:
                masks.append((host(o[0]), host(o[1])))
            else:
                masks.append((host(o), None))
    costprofile.add_kernel("tree",
                           execute_us=(time.perf_counter() - t_exec) * 1e6)

    out_json = []
    with tracing.span("batch.tree_rebuild"):
        for q, blocks in enumerate(plan.queries):
            ex = _MaskedExecutor(store, q, idx_per_query[q], masks,
                                 root_displays[q], device=device,
                                 device_threshold=device_threshold)
            results: dict[int, LevelNode] = {}
            try:
                for bi in execution_order(blocks):
                    ex._path = (bi,)
                    results[bi] = ex.run_block(blocks[bi])
                roots = [results[bi] for bi in range(len(blocks))]
                out_json.append(to_json(ex, roots))
            except ValueError:
                # the query's own error (an undefined var) in its host
                # half, after the run: the per-query engine gives it its
                # error object
                return None
    return out_json


def _lanes(plan: TreePlan) -> int:
    from dgraph_tpu_torch.engine.batch import _lane_count
    return _lane_count(len(plan.queries))


def _tree_inputs(store, plan: TreePlan, device, device_threshold: int):
    """The host half before a run: (graphs by (pred, dir), per-seed-slot
    rank lists, per-filter-slot allowed sets, per-query stage indexes,
    per-query root displays), or None when the group should be served
    per query (see run_tree_batch)."""
    from dgraph_tpu_torch.engine.batch import _ell_for

    n = store.n_nodes
    rels = {}
    for s in plan.stages:
        key = (s.attr, s.reverse)
        if key not in rels:
            g = _ell_for(store, s.attr, s.reverse)
            if g is None or g.n != n:    # empty relation: no kernel win
                return None
            rels[key] = g

    # per-query seeds (host root evaluation) and filter node sets
    seed_lists: list[list[np.ndarray]] = [[] for _ in range(plan.n_seeds)]
    filt_lists: list[list[np.ndarray]] = [[] for _ in plan.filt_paths]
    idx_per_query: list[_StageIndex] = []
    root_displays: list[dict[int, np.ndarray]] = []
    filt_cache: dict = {}        # one batch's filter sets, by constants
    for blocks in plan.queries:
        ex = Executor(store, device=device,
                      device_threshold=device_threshold)
        sidx = _StageIndex(store, plan, blocks)
        idx_per_query.append(sidx)
        displays: dict[int, np.ndarray] = {}
        root_displays.append(displays)
        for slot, bi in enumerate(plan.seed_blocks):
            try:
                display = ex.root_display(blocks[bi])
            except ValueError:
                return None
            displays[bi] = display
            seed_lists[slot].append(np.unique(display).astype(np.int32))
        for slot, path in enumerate(plan.filt_paths):
            sg = sidx.sg_by_path.get(path)
            if sg is None or sg.filters is None:
                return None
            ckey = _filter_const_key(sg.filters)
            allowed = filt_cache.get(ckey)
            if allowed is None:
                allowed = ex.filter_set(sg.filters)
                if allowed is None:
                    return None
                filt_cache[ckey] = allowed
            filt_lists[slot].append(allowed)
    return rels, seed_lists, filt_lists, idx_per_query, root_displays


def _tree_masks(n: int, lanes: int, seed_lists, filt_lists, device):
    """(seeds, filts): the per-lane rank sets packed into global-space
    masks on `device`, one upload each."""
    from dgraph_tpu_torch.ops.bfs import put_mask
    return (tuple(put_mask(_pack_global(n, lst, lanes), device)
                  for lst in seed_lists),
            tuple(put_mask(_pack_global(n, lst, lanes), device)
                  for lst in filt_lists))


def _filter_const_key(tree: FilterNode):
    """Canonical key INCLUDING constants — identical filters across the
    batch evaluate once."""
    if tree.op == "leaf":
        f = tree.func
        return ("leaf", f.name, f.attr, f.lang, tuple(map(str, f.args)),
                tuple(f.uids))
    return (tree.op, tuple(_filter_const_key(c) for c in tree.children))


def _pack_global(n: int, rank_lists, lanes: int) -> np.ndarray:
    """Per-lane rank sets → [n+1, lanes/32] uint32 mask, global space.
    Lanes holding the same array (a filter set the batch evaluated once)
    are packed together: one scatter per (array, word)."""
    m = np.zeros((n + 1, lanes // 32), np.uint32)
    shared: dict = {}
    for q, ranks in enumerate(rank_lists):
        if len(ranks):
            _arr, words = shared.setdefault(id(ranks), (ranks, {}))
            words[q // 32] = words.get(q // 32, 0) | (1 << (q % 32))
    for ranks, words in shared.values():
        rows = np.asarray(ranks, np.int64)
        for w, bits in words.items():
            m[rows, w] |= np.uint32(bits)
    return m


def _tree_kernel_for(store, plan: TreePlan, rels, n: int, W: int, device):
    """(run, stage descriptors) per (snapshot, signature, lane width,
    device); the placed ELL blocks (shared with the other lane families)
    and the permutation vectors are placed once per (predicate,
    direction, device) and shared across signatures."""
    import torch

    from dgraph_tpu_torch.engine.batch import (MIXED_TREE_HOSTS,
                                               _cache_host, _dev_for)
    from dgraph_tpu_torch.ops.bfs import make_ell_tree, prepare_parts

    # on the snapshot when every stage reads the snapshot's data (an ACL
    # view's readable predicates), on a pulled tablet's host when every
    # stage reads it; a routed view's mix of the snapshot's data and
    # pulled tablets goes on the snapshot, keyed by the pulled tablets'
    # hosts (`engine/batch.py:release_host` purges it); else on the
    # store itself
    rel_host = {rkey: _cache_host(store, *rkey) for rkey in rels}
    hosts = set(rel_host.values())
    snap = getattr(store, "_ell_host", store)
    if len(hosts) == 1:
        host = hosts.pop()
    elif store not in hosts and snap is not store:
        host = snap
        with _cache_lock:
            MIXED_TREE_HOSTS.add(snap)
    else:
        host = store
    tags = {rkey: (h,) if h is not host else () for rkey, h in
            rel_host.items()}
    key = (plan.sig, W, str(device),
           tuple(h for h in rel_host.values() if h is not host))
    with _cache_lock:
        fns = host.__dict__.setdefault("_tree_fns", {})
        if key in fns:
            return fns[key]
    placed = {rkey: _dev_for(store, *rkey, device)[1] for rkey in rels}
    with _cache_lock:
        devs = host.__dict__.setdefault("_tree_devs", {})
        for (attr, reverse), g in rels.items():
            dkey = (attr, reverse, str(device), tags[(attr, reverse)])
            if dkey not in devs:
                perm_in = np.concatenate([g.perm_order, [n]])
                out_idx = np.concatenate([g.new_of_old, [n]])
                devs[dkey] = (
                    torch.from_numpy(perm_in.astype(np.int64)).to(device),
                    torch.from_numpy(out_idx.astype(np.int64)).to(device),
                    prepare_parts(placed[(attr, reverse)]))
        stage_descs = []
        for s in plan.stages:
            perm_in, out_idx, prepared = devs[(s.attr, s.reverse,
                                               str(device),
                                               tags[(s.attr, s.reverse)])]
            stage_descs.append({
                "kind": s.kind, "prepared": prepared, "perm_in": perm_in,
                "out_idx": out_idx, "parent": s.parent,
                "filt": s.filt_slot, "depth": s.depth,
                "keep_hops": s.keep_hops})
        fns[key] = (make_ell_tree(stage_descs, n, W), stage_descs)
        return fns[key]


class _MaskedExecutor(Executor):
    """Per-query engine whose uid expansions are constrained by the run's
    level masks: a child level's edge list is the parents' CSR rows
    bit-tested against the stage mask (filters already folded in on the
    device), then ordering/pagination/vars/rendering run unchanged."""

    def __init__(self, store, lane: int, sidx: _StageIndex, masks,
                 root_displays=None, **kw):
        super().__init__(store, **kw)
        self._lane_word = lane // 32
        self._lane_bit = np.uint32(1 << (lane % 32))
        self._sidx = sidx
        self._masks = masks
        self._root_displays = root_displays or {}
        self._path: tuple = ()

    def root_display(self, sg: SubGraph) -> np.ndarray:
        # seed blocks evaluated their root once before the run; reuse it
        if self._path and len(self._path) == 1:
            cached = self._root_displays.get(self._path[0])
            if cached is not None:
                return cached
        return super().root_display(sg)

    def _run_fused(self, sg: SubGraph):
        # the rebuild reads the run's lane masks; a whole-block program
        # would redo the run's work (the reference re-runs it there)
        return None

    def _member(self, stage_idx: int, ranks: np.ndarray) -> np.ndarray:
        m = self._masks[stage_idx][0]
        return (m[ranks, self._lane_word] & self._lane_bit) != 0

    # -- expansion override --------------------------------------------------
    def _level_edges(self, sg: SubGraph, frontier: np.ndarray):
        stage_idx = self._sidx.by_path.get(self._path)
        if stage_idx is None:
            # a level the planner did not stage (host-only block)
            return super()._level_edges(sg, frontier)
        nbrs, seg, pos = self._gather_rows(sg, frontier)
        if len(nbrs):
            keep = self._member(stage_idx, nbrs)
            nbrs, seg, pos = nbrs[keep], seg[keep], pos[keep]
        nbrs, seg, pos = self.facet_filter_edges(sg, sg.attr, nbrs, seg,
                                                 pos)
        return nbrs, seg, pos, False

    def _gather_rows(self, sg: SubGraph, frontier: np.ndarray):
        rel = self.store.rel(sg.attr, sg.is_reverse)
        if not len(frontier) or rel.nnz == 0:
            return EMPTY, EMPTY, EMPTY64
        return csr_rows(rel, frontier)

    # -- tree descent with path bookkeeping ----------------------------------
    def _descend(self, parent: LevelNode) -> None:
        sg = parent.sg
        if sg.recurse is not None:
            stage_idx = self._sidx.by_path.get(self._path)
            if stage_idx is not None and \
                    self._masks[stage_idx][1] is not None:
                self._masked_recurse(parent, stage_idx)
                return
            from dgraph_tpu_torch.engine.recurse import expand_recurse
            expand_recurse(self, parent)
            return
        child_i = 0
        base_path = self._path
        for child_sg in self._concrete_children(parent):
            if self._expands(child_sg):
                self._path = (*base_path, child_i)
                child_i += 1
                parent.children.append(
                    self.run_child(child_sg, parent.nodes))
            else:
                parent.leaf_sgs.append(child_sg)
                self._record_leaf_vars(child_sg, parent)
        self._path = base_path

    def _masked_recurse(self, root: LevelNode, stage_idx: int) -> None:
        """RecurseData from the run's per-hop first-visit masks: hop h's
        kept edges are (parent CSR row) ∩ hops[h] — the host loop's
        loop=false semantics, filters already folded into the masks."""
        from dgraph_tpu_torch.engine.recurse import (RecurseData,
                                                     _bind_recurse_vars)

        sg = root.sg
        data = RecurseData(loop=False)
        for c in sg.children:
            (data.edge_sgs if self._expands(c)
             else data.leaf_sgs).append(c)
        esg = data.edge_sgs[0]
        _seen, hops = self._masks[stage_idx]
        w, bit = self._lane_word, self._lane_bit

        parents = root.nodes
        all_nodes = [root.nodes]
        p_parts, c_parts = [], []
        for h in range(hops.shape[0]):
            if not len(parents):
                break
            nbrs, seg, _pos = self._gather_rows(esg, parents)
            if not len(nbrs):
                break
            keep = (hops[h, nbrs, w] & bit) != 0
            if not keep.any():
                break
            p_parts.append(parents[seg[keep]].astype(np.int32))
            kept = nbrs[keep].astype(np.int32)
            c_parts.append(kept)
            parents = np.unique(kept)
            all_nodes.append(parents)
        if p_parts:
            data.edges[0] = (np.concatenate(p_parts),
                             np.concatenate(c_parts))
        data.all_nodes = np.unique(
            np.concatenate(all_nodes)).astype(np.int32)
        _bind_recurse_vars(self, root, data, sg)
        root.recurse_data = data
