"""Lane-kernel serving: many concurrent queries, a few lane-packed runs.

Port of `dgraph_tpu/engine/batch.py` plus the batch half of
`Alpha.query_batch` (`dgraph_tpu/server/api.py`). Structurally
compatible queries are packed into the bit-lanes of one frontier mask
and answered together; every hop of every family is the CUDA bucket hop
on the card. Three kernel families, planned in the reference's order:

  * unfiltered single-block @recurse — one `make_ell_recurse` run
    (`_BatchPlan`, no permutation translation);
  * unweighted `shortest` blocks (the IC13 shape, and numpaths > 1 as a
    level DAG) — staged `make_ell_step` blocks of SHORTEST_STAGE hops
    with a host walk-back over the reverse CSR (`_ShortestPlan`);
  * everything else that fits a level tree — nested levels, filters,
    filtered recurse, var chains (IC1-IC12, config 3) — one
    `make_ell_tree` run (engine/treebatch.py).

Per-query trees are rebuilt on the host from the run's masks and
rendered by the standard renderer, so each response equals the
per-query `Engine`'s. Queries no group takes (ineligible, in a group
below MIN_BATCH, unparsable) and groups whose run_batch returns None
(for reasons of the query or the data: an empty relation, a graph of
another size, a root evaluation or host rebuild that raises the query's
own error, a filter that is not a node set) are served one by one by the
per-query `Engine` on the same device; a query that fails there yields
an error object in its slot.

Deliberate differences from the reference: a kernel build or launch
failure, or an out-of-memory, raises out of `query_batch` — the
reference's group-failure catch in `Alpha.query_batch` and its OOM
degrade to the per-query path are not ported, so no failure of the card
is hidden. `@msgpass` queries join no group (the lane rebuild binds
no features; the reference groups them and drops their bindings). The
cost-prior launch gate and ordering (`_kernel_worth`,
`order_plans_by_cost`) wait for `utils/costprior` (ROADMAP Queue 1 item
9); groups launch in plan order under the count rule MIN_BATCH.
"""

from __future__ import annotations

import threading

import numpy as np
from torch.profiler import record_function

from dgraph_tpu_torch.engine.execute import Executor, LevelNode, csr_rows
from dgraph_tpu_torch.engine.execute import expands as _expands_schema
from dgraph_tpu_torch.engine.ir import SubGraph
from dgraph_tpu_torch.engine.outputnode import to_json
from dgraph_tpu_torch.engine.recurse import RecurseData, _bind_recurse_vars
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

MIN_BATCH = 4            # below this the per-query engine is cheaper
# Depths past any real graph's diameter go to the per-query engine
# (whose host loop exits when the frontier empties) instead of letting
# a client-controlled depth size device buffers.
MAX_KERNEL_DEPTH = 64
# shortest lane-BFS: hops per make_ell_step block. The staged host loop
# stops as soon as every lane resolved (found / exhausted), so a short
# path never pays the full depth cap; the carries are handed forward.
SHORTEST_STAGE = 8


class _BatchPlan:
    def __init__(self, blocks, attr, reverse, depth):
        self.blocks = blocks          # one root SubGraph per query
        self.attr = attr
        self.reverse = reverse
        self.depth = depth


class _ShortestPlan:
    """One shortest-path kernel group: same predicate/direction/depth
    cap/numpaths/weight bounds across the batch; per-query (blocks,
    shortest block index, src uid, dst uid)."""

    def __init__(self, sig, items):
        self.sig = sig
        (_tag, self.attr, self.reverse, self.depth, self.k,
         self.minw, self.maxw, self.first_visit) = sig
        self.queries = [blocks for blocks, _bi, _s, _d in items]
        self.block_idx = [bi for _b, bi, _s, _d in items]
        self.src_uids = [s for _b, _bi, s, _d in items]
        self.dst_uids = [d for _b, _bi, _s, d in items]


def _expands(store, c: SubGraph) -> bool:
    return _expands_schema(store.schema, c)


def _eligible(store, blocks):
    """(signature, root_sg) when the query fits the lane kernel, else
    None. The signature is what must MATCH across a kernel launch."""
    if len(blocks) != 1:
        return None
    sg = blocks[0]
    if sg.msgpass is not None:
        # the lane run rebuilds no @msgpass binding: such queries are
        # served per query (the reference groups them and drops their
        # bindings, ROADMAP Queue 3)
        return None
    r = sg.recurse
    if r is not None and r.depth and r.depth > MAX_KERNEL_DEPTH:
        return None
    if (r is None or r.loop or not r.depth or sg.shortest is not None
            or sg.filters is not None or sg.first or sg.offset
            or sg.after or sg.orders or sg.groupby or sg.cascade
            or sg.normalize or sg.var_name):
        return None
    edge_sgs = [c for c in sg.children if _expands(store, c)]
    if len(edge_sgs) != 1:
        return None
    e = edge_sgs[0]
    if (e.filters is not None or e.facet_filter is not None
            or e.facet_orders or e.facet_keys is not None
            or e.first or e.offset or e.after or e.orders
            or e.var_name):
        return None
    return (e.attr, e.is_reverse, r.depth), sg


def _eligible_shortest(store, blocks):
    """(signature, (blocks, shortest block idx, src uid, dst uid)) when
    the query's `shortest` block fits the lane-BFS, else None.

    Eligible: UNWEIGHTED shortest over exactly one edge predicate, no
    filters/facets on the edge, and edges both ways (the host walk-back
    follows in-edges of the found levels). numpaths == 1 rides the
    first-visit BFS; numpaths > 1 or weight bounds ride the level DAG.
    Facet-weighted relaxation (the IC14 `@facets(weight)` shape) stays
    on the per-query path, as in the reference."""
    from dgraph_tpu_torch.engine.shortest import MAX_PATH_DEPTH

    sidx = [i for i, b in enumerate(blocks) if b.shortest is not None]
    if len(sidx) != 1:
        return None
    bi = sidx[0]
    sg = blocks[bi]
    a = sg.shortest
    if a.weight_facet:
        return None
    edge_sgs = [c for c in sg.children if _expands(store, c)]
    if len(edge_sgs) != 1:
        return None
    e = edge_sgs[0]
    if (e.filters is not None or e.facet_keys is not None
            or e.facet_filter is not None or e.facet_orders
            or e.children or e.first or e.offset or e.after or e.orders
            or e.var_name or e.lang):
        return None
    k = max(1, a.numpaths)
    bounded = a.minweight > float("-inf") or a.maxweight < float("inf")
    max_depth = a.depth or MAX_PATH_DEPTH
    if np.isfinite(a.maxweight):
        max_depth = min(max_depth, max(int(a.maxweight), 0))
    if max_depth < 1 or max_depth > MAX_KERNEL_DEPTH:
        return None
    if (store.rel(e.attr, not e.is_reverse).nnz == 0
            or store.rel(e.attr, e.is_reverse).nnz == 0):
        return None
    first_visit = k == 1 and not bounded
    sig = ("shortest", e.attr, e.is_reverse, max_depth, k,
           a.minweight, a.maxweight, first_visit)
    return sig, (blocks, bi, a.from_uid, a.to_uid)


def plan_batch(store, queries_blocks):
    """A plan only when EVERY query fits one lane-kernel launch."""
    plans, leftover = plan_batch_groups(store, queries_blocks)
    if len(plans) == 1 and not leftover:
        return plans[0][0]
    return None


def plan_batch_groups(store, queries_blocks):
    """Split a MIXED batch into structurally compatible kernel groups:
    ([(plan, original_indices)], leftover_indices). Each query goes to
    the first family that takes it — unfiltered single-block @recurse
    (`_BatchPlan`), unweighted shortest (`_ShortestPlan`), level tree
    (`TreePlan`) — and groups smaller than MIN_BATCH join the leftovers
    (the reference's count rule; its cost-prior override is not ported)."""
    from dgraph_tpu_torch.engine.treebatch import plan_tree

    groups: dict = {}
    sp_groups: dict = {}
    tree_groups: dict = {}
    leftover: list[int] = []
    for i, blocks in enumerate(queries_blocks):
        er = _eligible(store, blocks)
        if er is not None:
            groups.setdefault(er[0], []).append((i, er[1]))
            continue
        es = _eligible_shortest(store, blocks)
        if es is not None:
            sp_groups.setdefault(es[0], []).append((i, es[1]))
            continue
        tp = plan_tree(store, blocks)
        if tp is not None:
            tree_groups.setdefault(tp[0], []).append((i, blocks, tp[1]))
            continue
        leftover.append(i)
    plans = []
    for sig, items in groups.items():
        if len(items) < MIN_BATCH:
            leftover.extend(i for i, _ in items)
        else:
            plans.append((_BatchPlan([sg for _, sg in items],
                                     sig[0], sig[1], sig[2]),
                          [i for i, _ in items]))
    for sig, items in sp_groups.items():
        if len(items) < MIN_BATCH:
            leftover.extend(i for i, _ in items)
        else:
            plans.append((_ShortestPlan(sig, [it for _, it in items]),
                          [i for i, _ in items]))
    for sig, items in tree_groups.items():
        if len(items) < MIN_BATCH:
            leftover.extend(i for i, _b, _p in items)
        else:
            plan = items[0][2]
            plan.queries = [b for _i, b, _p in items]
            plans.append((plan, [i for i, _b, _p in items]))
    leftover.sort()
    return plans, leftover


# -- plan cache --------------------------------------------------------------

# batch plans keyed by (schema fingerprint, query texts): a repeated
# query template skips parse + planning. Plans carry only parsed
# SubGraphs — seeds are evaluated against the CURRENT store at run time.
_PLAN_CACHE_CAP = 256
_plan_cache: dict = {}
_cache_lock = threading.Lock()


def _schema_fingerprint(store) -> tuple:
    sch = store.schema
    return (tuple(sorted((k, repr(v)) for k, v in sch.predicates.items())),
            tuple(sorted((k, repr(v)) for k, v in sch.types.items())))


def plan_batch_groups_cached(store, dqls: list):
    """parse + plan_batch_groups with plan memoization. Returns
    ([(plan, original_indices)], leftover_indices); unparseable queries
    land in leftover."""
    from dgraph_tpu_torch.dql.parser import parse

    key = (_schema_fingerprint(store), tuple(dqls))
    with _cache_lock:
        cached = _plan_cache.get(key)
    if cached is not None:
        return cached
    parsed = {}
    for i, q in enumerate(dqls):
        try:
            parsed[i] = parse(q)
        except ValueError:
            pass
    order = sorted(parsed)
    plans, group_left = plan_batch_groups(store, [parsed[i] for i in order])
    plans = [(p, [order[j] for j in idxs]) for p, idxs in plans]
    leftover = sorted([order[j] for j in group_left]
                      + [i for i in range(len(dqls)) if i not in parsed])
    out = (plans, leftover)
    with _cache_lock:
        # store under the POST-planning fingerprint: planning may create
        # default schema entries for unknown predicates
        _plan_cache[(_schema_fingerprint(store), tuple(dqls))] = out
        while len(_plan_cache) > _PLAN_CACHE_CAP:
            _plan_cache.pop(next(iter(_plan_cache)))
    return out


def query_batch(store, dqls: list, device=DEFAULT_DEVICE,
                device_threshold: int = 512) -> list:
    """Serve many queries at once: each kernel group is ONE lane-packed
    run on `device` (run_batch); the rest go through the per-query
    Engine on the same device, whose failures become
    `{"errors": [{"message": ...}]}` in their slot. Returns one JSON
    dict per query, in order."""
    from dgraph_tpu_torch.engine import Engine

    dev = resolve_device(device)
    plans, leftover = plan_batch_groups_cached(store, dqls)
    leftover = list(leftover)        # the cached list is never mutated
    results: list = [None] * len(dqls)
    for plan, idxs in plans:
        out = run_batch(store, plan, dev, device_threshold)
        if out is None:
            leftover.extend(idxs)
            continue
        for i, o in zip(idxs, out):
            results[i] = o
    eng = Engine(store, device=dev, device_threshold=device_threshold)
    with record_function("batch.leftover"):
        for i in sorted(leftover):
            try:
                results[i] = eng.query(dqls[i])
            except ValueError as e:
                results[i] = {"errors": [{"message": str(e)}]}
    return results


def run_batch(store, plan, device=DEFAULT_DEVICE,
              device_threshold: int = 512) -> list | None:
    """Execute one kernel group on `device` and render each query with
    the standard renderer. Dispatches on the plan's family: the level
    tree in engine/treebatch.py, the shortest lane-BFS in
    `_run_shortest_batch`, the recurse run here. None when the group is
    better served per query for reasons of the query or the data (see
    the module docstring); a kernel failure raises."""
    from dgraph_tpu_torch.engine.treebatch import TreePlan, run_tree_batch

    dev = resolve_device(device)
    if isinstance(plan, TreePlan):
        return run_tree_batch(store, plan, dev, device_threshold)
    if isinstance(plan, _ShortestPlan):
        return _run_shortest_batch(store, plan, dev, device_threshold)
    g = _ell_for(store, plan.attr, plan.reverse)
    if g is None:
        return None
    from dgraph_tpu_torch.ops.bfs import pack_seed_masks, put_mask

    # root seed ranks per query (host index lookups). Lane words round
    # UP to a power of two: padding lanes are zero-seeded and free
    ex0 = Executor(store, device=dev, device_threshold=device_threshold)
    seeds = [ex0.root_ranks(sg) for sg in plan.blocks]
    B = _lane_count(len(seeds))
    seed_lists = seeds + [np.zeros(0, np.int32)] * (B - len(seeds))
    mask0 = pack_seed_masks(g, seed_lists)
    with record_function("batch.recurse_run"):
        fn = _recurse_for(store, plan.attr, plan.reverse, mask0.shape[1],
                          dev)
        # the seed mask is donated to the run (ops/bfs.py): a fresh
        # device copy per launch
        _last, _seen, _edges, hops = fn(put_mask(mask0, dev), plan.depth,
                                        True)
        hops = hops.cpu().numpy().view(np.uint32)     # [depth, n+1, W]
    rel = store.rel(plan.attr, plan.reverse)

    with record_function("batch.recurse_rebuild"):
        root_nodes = [np.unique(s).astype(np.int32) for s in seeds]
        datas = _rebuild_recurse_batch(store, g, rel, hops, plan.blocks,
                                       root_nodes)
        out = []
        for q, sg in enumerate(plan.blocks):
            ex = Executor(store, device=dev,
                          device_threshold=device_threshold)
            node = LevelNode(sg=sg, nodes=root_nodes[q],
                             display=root_nodes[q])
            _bind_recurse_vars(ex, node, datas[q], sg)
            node.recurse_data = datas[q]
            out.append(to_json(ex, [node]))
    return out


def _lane_count(nq: int) -> int:
    words = -(-nq // 32)
    return 32 * (1 << (words - 1).bit_length() if words > 1 else 1)


def _rebuild_recurse_batch(store, g, rel, hops, blocks,
                           root_nodes) -> list:
    """Per-query first-visit trees from the kernel's per-hop fresh
    masks, ONE batched numpy pass per hop: all queries' parents expand
    through a single shared CSR gather, membership tests are packed-mask
    bit tests, and the next frontier falls out of the kept children —
    exactly the host loop's loop=false semantics."""
    B = len(blocks)
    depth = hops.shape[0]
    datas = []
    for sg in blocks:
        d = RecurseData(loop=False)
        for c in sg.children:
            (d.edge_sgs if _expands(store, c)
             else d.leaf_sgs).append(c)
        datas.append(d)

    qword = np.array([q // 32 for q in range(B)], np.int64)
    qbit = np.array([np.uint32(1 << (q % 32)) for q in range(B)],
                    np.uint32)
    parents = [rn.astype(np.int32) for rn in root_nodes]
    all_nodes = [[rn] for rn in root_nodes]
    p_parts: list[list] = [[] for _ in range(B)]
    c_parts: list[list] = [[] for _ in range(B)]
    for h in range(depth):
        live = [q for q in range(B) if len(parents[q])]
        if not live:
            break
        cat = np.concatenate([parents[q] for q in live])
        counts = np.array([len(parents[q]) for q in live])
        qid = np.repeat(np.arange(len(live)), counts)
        nbrs, seg, _pos = csr_rows(rel, cat)
        if not len(nbrs):
            break
        qe = qid[seg]                      # per-edge live-query index
        rows = g.new_of_old[nbrs]          # permuted mask rows
        lanes = np.asarray(live, np.int64)
        w = qword[lanes[qe]]
        b = qbit[lanes[qe]]
        keep = (hops[h, rows, w] & b) != 0
        kp, kc, kq = cat[seg[keep]], nbrs[keep], qe[keep]
        # edges are query-grouped (cat was), so one split serves all
        bounds = np.searchsorted(kq, np.arange(len(live) + 1))
        for i, q in enumerate(live):
            lo, hi = bounds[i], bounds[i + 1]
            if lo == hi:
                parents[q] = np.zeros(0, np.int32)
                continue
            p_parts[q].append(kp[lo:hi].astype(np.int32))
            c_parts[q].append(kc[lo:hi].astype(np.int32))
            fresh = np.unique(kc[lo:hi]).astype(np.int32)
            parents[q] = fresh
            all_nodes[q].append(fresh)
    for q in range(B):
        if p_parts[q]:
            datas[q].edges[0] = (np.concatenate(p_parts[q]),
                                 np.concatenate(c_parts[q]))
        datas[q].all_nodes = np.unique(
            np.concatenate(all_nodes[q])).astype(np.int32)
    return datas


# -- shortest lane-BFS -------------------------------------------------------

def _run_shortest_batch(store, plan: _ShortestPlan, device,
                        device_threshold: int) -> list | None:
    """Execute one shortest group: seed each lane with its query's
    source, run the staged lane-BFS (first-visit masks for numpaths=1,
    the full level DAG otherwise), then rebuild each query's PathData on
    the host by walking the found levels BACKWARD over the reverse CSR —
    the same paths, in the same order, as engine/shortest.py's per-query
    loop. One host copy of each stage's levels; the per-lane checks
    (found, frontier exhausted) read those copies."""
    from dgraph_tpu_torch.engine.varorder import execution_order
    from dgraph_tpu_torch.ops.bfs import put_mask

    g = _ell_for(store, plan.attr, plan.reverse)
    if g is None:
        return None
    rrel = store.rel(plan.attr, not plan.reverse)
    if rrel.nnz == 0:
        return None
    n = g.n
    B = len(plan.queries)
    src = store.rank_of(np.asarray(plan.src_uids, np.int64))
    dst = store.rank_of(np.asarray(plan.dst_uids, np.int64))
    W = _lane_count(B) // 32

    # lanes needing a kernel at all: known endpoints, src != dst
    active = [q for q in range(B)
              if src[q] >= 0 and dst[q] >= 0 and src[q] != dst[q]]
    levels: list[np.ndarray] = []      # [n+1, W] per hop, permuted space
    if active:
        mask0 = np.zeros((n + 1, W), np.uint32)
        for q in active:
            r = g.new_of_old[int(src[q])]
            mask0[r, q // 32] |= np.uint32(1 << (q % 32))
        step = _step_for(store, plan.attr, plan.reverse, W,
                         plan.first_visit, device)
        unresolved = set(active)
        dst_rows = {q: int(g.new_of_old[int(dst[q])]) for q in active}
        frontier = put_mask(mask0, device)
        seen = put_mask(mask0, device)
        done = 0
        while done < plan.depth and unresolved:
            chunk = min(SHORTEST_STAGE, plan.depth - done)
            with record_function("batch.step_run"):
                frontier, seen, hops = step(frontier, seen, chunk)
                hops_np = hops.cpu().numpy().view(np.uint32)
            for h in range(chunk):
                lvl = hops_np[h]
                levels.append(lvl)
                alive = np.bitwise_or.reduce(lvl[:n], axis=0)
                for q in sorted(unresolved):
                    wq, bq = q // 32, np.uint32(1 << (q % 32))
                    if plan.first_visit and (lvl[dst_rows[q], wq] & bq):
                        unresolved.discard(q)   # found: walk back later
                    elif not (alive[wq] & bq):
                        unresolved.discard(q)   # frontier exhausted
            done += chunk

    try:
        order_of = [execution_order(blocks) for blocks in plan.queries]
    except ValueError:
        return None
    out = []
    with record_function("batch.shortest_rebuild"):
        for q in range(B):
            blocks = plan.queries[q]
            data = _shortest_path_data(store, plan, g, rrel, levels,
                                       int(src[q]), int(dst[q]), q)
            ex = Executor(store, device=device,
                          device_threshold=device_threshold)
            results: dict[int, LevelNode] = {}
            try:
                for bi in order_of[q]:
                    sg = blocks[bi]
                    if bi == plan.block_idx[q]:
                        node = LevelNode(sg=sg, nodes=data.nodes,
                                         path_data=data)
                        if sg.var_name:
                            ex.uid_vars[sg.var_name] = data.nodes
                        results[bi] = node
                    else:
                        results[bi] = ex.run_block(sg)
                out.append(to_json(ex, [results[i]
                                        for i in range(len(blocks))]))
            except ValueError:
                # the query's own error in a host block: the per-query
                # engine gives it its error object
                return None
    return out


def _level_member(g, levels, lvl: int, ranks: np.ndarray, q: int):
    """Bit-test OLD ranks against the level-`lvl` fresh/level mask."""
    m = levels[lvl]
    rows = g.new_of_old[ranks]
    return (m[rows, q // 32] & np.uint32(1 << (q % 32))) != 0


def _shortest_path_data(store, plan, g, rrel, levels, src: int,
                        dst: int, q: int):
    """Rebuild one lane's PathData from the kernel levels — the exact
    paths (and enumeration ORDER) the host loop produces."""
    from dgraph_tpu_torch.engine.shortest import PathData

    blocks = plan.queries[q]
    sg = blocks[plan.block_idx[q]]
    data = PathData(edge_sgs=[c for c in sg.children
                              if _expands(store, c)])
    if src < 0 or dst < 0:
        return data
    k = plan.k

    def parents_of(rank: int, lvl: int) -> list[int]:
        """In-neighbors of `rank` on level `lvl`, ascending — the host
        loop's parent-list order (sorted frontier, one predicate)."""
        preds = rrel.row(rank).astype(np.int64)
        if not len(preds):
            return []
        if lvl < 0:
            return [int(src)] if (preds == src).any() else []
        keep = _level_member(g, levels, lvl, preds, q)
        return [int(p) for p in preds[keep]]

    paths: list[list[tuple[int, int]]] = []
    if src == dst:
        if plan.minw <= 0 <= plan.maxw:
            paths.append([(src, -1)])
    elif plan.first_visit:
        found = None
        for h in range(len(levels)):
            if _level_member(g, levels, h, np.array([dst]), q)[0]:
                found = h
                break
        if found is not None:
            # walk back choosing each level's FIRST parent — first-visit
            # BFS makes that exactly the host fast path's plist[0]
            rev = [(dst, 0)]
            cur = dst
            for lvl in range(found - 1, -2, -1):
                cur = parents_of(cur, lvl)[0]
                rev.append((cur, 0) if lvl >= 0 else (cur, -1))
            paths.append(rev[::-1])
    else:
        # level-DAG enumeration in the host's order: per level (length
        # order), DFS over ascending parent lists, simple paths only
        def walk_back(lvl: int, rank: int, on_path: frozenset):
            for p in parents_of(rank, lvl - 1):
                if lvl == 0:
                    if p == src:
                        yield [(src, -1), (rank, 0)]
                elif p not in on_path:
                    for prefix in walk_back(lvl - 1, p, on_path | {p}):
                        yield prefix + [(rank, 0)]

        for lvl in range(len(levels)):
            hops_count = lvl + 1
            if not (plan.minw <= hops_count <= plan.maxw):
                continue
            if not _level_member(g, levels, lvl, np.array([dst]), q)[0]:
                continue
            for path in walk_back(lvl, dst, frozenset([dst, src])):
                paths.append(path)
                if len(paths) >= k:
                    break
            if len(paths) >= k:
                break
    data.paths = paths[:k]
    if data.paths:
        data.nodes = np.unique(np.array(
            [r for p in data.paths for r, _ in p], np.int32))
    return data


# -- per-store kernel caches -------------------------------------------------

def _ell_for(store, attr: str, reverse: bool):
    """EllGraph per (store, predicate, direction), built once; None when
    the relation has no edges."""
    from dgraph_tpu_torch.ops.bfs import build_ell

    key = (attr, reverse)
    with _cache_lock:
        cache = store.__dict__.setdefault("_ell_cache", {})
        if key not in cache:
            rel = store.rel(attr, reverse)
            cache[key] = (build_ell(rel.indptr, rel.indices)
                          if rel.nnz else None)
        return cache[key]


def _dev_for(store, attr: str, reverse: bool, device):
    """(EllGraph, DeviceEll) per (store, pred, dir, device): the index
    blocks are placed once and shared by every lane width."""
    from dgraph_tpu_torch.ops.bfs import device_ell

    g = _ell_for(store, attr, reverse)
    key = (attr, reverse, str(device))
    with _cache_lock:
        devs = store.__dict__.setdefault("_ell_devs", {})
        if key not in devs:
            devs[key] = device_ell(g, device)
        return g, devs[key]


def _recurse_for(store, attr: str, reverse: bool, W: int, device):
    """Recurse runner per (store, pred, dir, lane width, device)."""
    from dgraph_tpu_torch.ops.bfs import make_ell_recurse

    g, dev = _dev_for(store, attr, reverse, device)
    key = (attr, reverse, W, str(device))
    with _cache_lock:
        fns = store.__dict__.setdefault("_ell_fns", {})
        if key not in fns:
            fns[key] = make_ell_recurse(dev, g.outdeg, g.n, W,
                                        count_edges=False)
        return fns[key]


def _step_for(store, attr: str, reverse: bool, W: int, first_visit: bool,
              device):
    """Resumable hop block per (store, pred, dir, lane width, family,
    device) — the staged shortest path's program."""
    from dgraph_tpu_torch.ops.bfs import make_ell_step

    g, dev = _dev_for(store, attr, reverse, device)
    key = ("step", attr, reverse, W, first_visit, str(device))
    with _cache_lock:
        fns = store.__dict__.setdefault("_ell_fns", {})
        if key not in fns:
            fns[key] = make_ell_step(dev, g.n, W, first_visit=first_visit)
        return fns[key]
