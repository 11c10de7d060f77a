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

Failures: a kernel group whose launch fails for want of device memory
gets the memory governor's lifecycle (utils/memgov.py) at the sites
`bfs.ell_recurse` and `bfs.ell_step`: evict to the low watermark and
ONE retry of the same launch on the card. A second classified
allocation failure is counted, logged at warning and raises out of
`query_batch` like any other failure; no group is served from the host
in its place, and nothing stays degraded, so the next request launches
on the card again. Nothing is caught around a group: a kernel build or
launch failure, an illegal address, an assertion or any other error
raises out of `query_batch` — the reference's catch-all around a group
(`Alpha.query_batch`) is not ported, so no failure of the card or of a
kernel is hidden. `@msgpass` queries join no group (the lane rebuild
binds no features; the reference groups them and drops their bindings).

Cost model (utils/costprior.py, utils/costprofile.py): a group below
MIN_BATCH still launches when its shape's prior predicts at least
KERNEL_WORTH_US (`_kernel_worth`). Over a mesh that spans processes
the lead's priors decide, agreed once per batch (`_agreed_groups`): a
rank's own timings must not send a group to a lane kernel on one rank
and to the mesh's collectives on another; with priors on
(`costprior.enabled`),
`query_batch` launches its groups longest-predicted first
(`order_plans_by_cost`, which gauges `plan_pack_imbalance{stage=}`):
the group's launch-shape prior, learned from each group's own measured
run (`costprior.learn_group`), else the feature fit where it predicts
more than 0 µs, else the query count. Results are written by
index, so the order changes no answer. Each launch feeds the request's
cost record: its shape (`recurse:<pred>~d<depth>`,
`shortest:<pred>~d<depth>`, `tree:*~d<stages>`), lanes, padding, depth,
bucket blocks, execute µs, launches and the gap between them, ELL build
µs and the plan memo's hit bit. The plan memo and the per-store ELL
blocks, their device copies and the runners are governed caches
(`batch.plan`, `batch.ell`, `batch.ell_dev`, `batch.kernel`).

Request lifecycle: a deadline checkpoint (utils/deadline.py) runs before
each group's run is issued ("kernel"), before each staged shortest
block ("kernel") and per walked-back level ("bfs"); groups count in
`kernel_group_launches_total`, `kernel_group_queries_total` and
`kernel_padded_lanes_total{family=}`, the plan memo in
`plan_cache_{hits,misses}_total{cache="batch"}`.
"""

from __future__ import annotations

import time
import weakref

import numpy as np

from dgraph_tpu_torch.engine.execute import Executor, LevelNode, csr_rows
from dgraph_tpu_torch.engine.execute import expands as _expands_schema
from dgraph_tpu_torch.engine.ir import SubGraph
from dgraph_tpu_torch.engine.outputnode import to_json
from dgraph_tpu_torch.engine.recurse import RecurseData, _bind_recurse_vars
from dgraph_tpu_torch.utils import (costprior, costprofile, deadline, memgov,
                                    tracing)
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dgraph_tpu_torch.utils.jitcache import Memo
from dgraph_tpu_torch.utils.metrics import METRICS
from dgraph_tpu_torch.utils import locks

MIN_BATCH = 4            # below this the per-query engine is cheaper
# a group SMALLER than MIN_BATCH still earns a launch when its predicted
# cost says the work dwarfs the launch overhead (utils/costprior.py;
# priors below the sample floor leave the count rule in charge)
KERNEL_WORTH_US = 5_000.0
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


def plan_batch_groups(store, queries_blocks,
                      agreed: frozenset | None = None):
    """Split a MIXED batch into structurally compatible kernel groups:
    ([(plan, original_indices)], leftover_indices). Each query goes to
    the first family that takes it — unfiltered single-block @recurse
    (`_BatchPlan`), unweighted shortest (`_ShortestPlan`), level tree
    (`TreePlan`) — and a group smaller than MIN_BATCH joins the
    leftovers unless its shape's prior says it is worth a launch
    (`_kernel_worth`; `agreed`, the shapes the lead of a mesh across
    processes calls worth, in place of this process's priors)."""
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
        if not _kernel_worth(f"recurse:{sig[0]}~d{sig[2]}", len(items),
                             agreed):
            leftover.extend(i for i, _ in items)
        else:
            plans.append((_BatchPlan([sg for _, sg in items],
                                     sig[0], sig[1], sig[2]),
                          [i for i, _ in items]))
    for sig, items in sp_groups.items():
        if not _kernel_worth(f"shortest:{sig[1]}~d{sig[3]}", len(items),
                             agreed):
            leftover.extend(i for i, _ in items)
        else:
            plans.append((_ShortestPlan(sig, [it for _, it in items]),
                          [i for i, _ in items]))
    for sig, items in tree_groups.items():
        plan = items[0][2]
        if not _kernel_worth(f"tree:*~d{len(plan.stages)}", len(items),
                             agreed):
            leftover.extend(i for i, _b, _p in items)
        else:
            plan.queries = [b for _i, b, _p in items]
            plans.append((plan, [i for i, _b, _p in items]))
    leftover.sort()
    return plans, leftover


def _kernel_worth(shape: str, n: int,
                  agreed: frozenset | None = None) -> bool:
    """Launch gate by predicted COST as well as query count: MIN_BATCH
    keeps its role, but a smaller group whose per-shape prior says the
    work dwarfs the launch overhead (KERNEL_WORTH_US) still launches.
    Without a trusted prior (unseen shape, priors off) the count rule
    decides. `agreed` is the lead's answer over a mesh across
    processes, the shapes it calls worth, in place of this process's
    priors."""
    if n >= MIN_BATCH:
        return True
    if n == 0:
        return False
    if agreed is not None:
        return shape in agreed
    if not costprior.enabled():
        return False
    us = costprior.PRIORS.predict_shape(shape)
    return us is not None and us >= KERNEL_WORTH_US


# -- cost-ordered launches ---------------------------------------------------

def _plan_shape(plan) -> str:
    """The shape component a plan's launch records (the prior's key)."""
    from dgraph_tpu_torch.engine.treebatch import TreePlan
    if isinstance(plan, _ShortestPlan):
        return f"shortest:{plan.attr}~d{plan.depth}"
    if isinstance(plan, TreePlan):
        return f"tree:*~d{len(plan.stages)}"
    return f"recurse:{plan.attr}~d{plan.depth}"


def _plan_queries(plan) -> int:
    from dgraph_tpu_torch.engine.treebatch import TreePlan
    if isinstance(plan, (_ShortestPlan, TreePlan)):
        return len(plan.queries)
    return len(plan.blocks)


def plan_cost_us(plan) -> float:
    """Predicted µs of one group launch: the per-shape prior first, the
    feature least-squares fit for unseen shapes (lanes, depth and
    queries are known at plan time) where it predicts more than 0 µs,
    the query count as the last proxy (every query worth ~1 ms)."""
    from dgraph_tpu_torch.engine.treebatch import TreePlan
    n = _plan_queries(plan)
    us = costprior.PRIORS.predict_shape(_plan_shape(plan))
    if us is None:
        depth = (len(plan.stages) if isinstance(plan, TreePlan)
                 else plan.depth)
        us = costprior.PRIORS.predict_features(
            {"lanes": _lane_count(n), "depth": depth, "queries": n})
    if us is None or us <= 0:
        # no fit yet, or one that clamps at 0 µs (a line over unlike
        # shapes goes negative at a lane group's features): no prediction
        us = 1000.0 * n
    return float(us)


def order_plans_by_cost(plans):
    """Kernel groups in launch order, DESCENDING predicted cost (longest
    first: under a shared deadline the expensive group starts while the
    budget is freshest, and the makespan shrinks). Gauges the pack
    imbalance across the launches both ways — query counts and
    predicted costs (`plan_pack_imbalance{stage=}`). Returns a new
    list; the memoized plan list is never mutated."""
    plans = list(plans)
    if not costprior.enabled() or len(plans) < 2:
        return plans
    counts = [float(_plan_queries(p)) for p, _ in plans]
    costs = [plan_cost_us(p) for p, _ in plans]
    for stage, vals in (("count", counts), ("predicted", costs)):
        mean = sum(vals) / len(vals)
        METRICS.set_gauge("plan_pack_imbalance",
                          max(vals) / mean if mean > 0 else 1.0,
                          stage=stage)
    order = sorted(range(len(plans)), key=lambda i: -costs[i])
    return [plans[i] for i in order]


# -- plan cache --------------------------------------------------------------

# batch plans keyed by (schema fingerprint, query texts): a repeated
# query template skips parse + planning. Plans carry only parsed
# SubGraphs — seeds are evaluated against the CURRENT store at run time.
_plan_memo = Memo("batch.plan", capacity=256, governed="batch.plan")
_cache_lock = locks.make_lock("batch.plan_cache")


def _schema_fingerprint(store) -> tuple:
    sch = store.schema
    return (tuple(sorted((k, repr(v)) for k, v in sch.predicates.items())),
            tuple(sorted((k, repr(v)) for k, v in sch.types.items())))


def plan_batch_groups_cached(store, dqls: list,
                             agreed: frozenset | None = None):
    """parse + plan_batch_groups with plan memoization (`agreed` as
    there, and part of the key). Returns ([(plan, original_indices)],
    leftover_indices); unparseable queries land in leftover."""
    from dgraph_tpu_torch.dql.parser import parse

    key = (_schema_fingerprint(store), tuple(dqls), agreed)
    cached = _plan_memo.get(key)
    if cached is not None:
        METRICS.inc("plan_cache_hits_total", cache="batch")
        costprofile.note("plan_cache_hit", 1)
        return cached
    METRICS.inc("plan_cache_misses_total", cache="batch")
    costprofile.note("plan_cache_hit", 0)
    t_plan = time.perf_counter()
    with tracing.span("batch.plan", queries=len(dqls)):
        parsed = {}
        for i, q in enumerate(dqls):
            try:
                parsed[i] = parse(q)
            except ValueError:
                pass
        order = sorted(parsed)
        plans, group_left = plan_batch_groups(
            store, [parsed[i] for i in order], agreed)
    plans = [(p, [order[j] for j in idxs]) for p, idxs in plans]
    leftover = sorted([order[j] for j in group_left]
                      + [i for i in range(len(dqls)) if i not in parsed])
    out = (plans, leftover)
    plan_us = (time.perf_counter() - t_plan) * 1e6
    costprofile.add("plan_us", int(plan_us))
    # store under the POST-planning fingerprint: planning may create
    # default schema entries for unknown predicates
    _plan_memo.put((_schema_fingerprint(store), tuple(dqls), agreed), out,
                   rebuild_us=plan_us)
    memgov.GOVERNOR.maybe_evict("host")
    return out


def _agreed_groups(store, dqls: list, mesh):
    """The kernel groups of a batch over a mesh that spans processes, as
    the lead forms them: the lead plans with its own priors and
    publishes the shapes of the groups below MIN_BATCH it launched (the
    only groups a prior decides); every other rank plans with that
    answer (`parallel/mesh.agree`, one store round trip per batch)."""
    from dgraph_tpu_torch.parallel.mesh import agree, agree_key

    key = agree_key("batch", dqls)
    if mesh.is_lead:
        plans, leftover = plan_batch_groups_cached(store, dqls)
        agree(mesh, key, sorted({_plan_shape(p) for p, idxs in plans
                                 if len(idxs) < MIN_BATCH}))
        return plans, leftover
    return plan_batch_groups_cached(store, dqls,
                                    agreed=frozenset(agree(mesh, key)))


def query_batch(store, dqls: list, device=DEFAULT_DEVICE,
                device_threshold: int = 512, mesh=None) -> list:
    """Serve many queries at once: each kernel group is ONE lane-packed
    run on `device` (run_batch), launched longest-predicted first when
    the priors are on; the rest go through the per-query Engine on the
    same device (over `mesh` when one is given, as the reference's
    Alpha serves them), whose failures become `{"errors": [{"message":
    ...}]}` in their slot. A group's failure, an allocation failure its retry
    did not absorb among them, raises. Returns one JSON dict per query,
    in order. Over a mesh that spans processes the groups are the lead's
    (`_agreed_groups`), so every rank sends the same queries to the
    mesh."""
    from dgraph_tpu_torch.engine import Engine

    dev = resolve_device(device)
    if mesh is not None and mesh.spans_processes:
        plans, leftover = _agreed_groups(store, dqls, mesh)
    else:
        plans, leftover = plan_batch_groups_cached(store, dqls)
    leftover = list(leftover)        # the cached list is never mutated
    results: list = [None] * len(dqls)
    for plan, idxs in order_plans_by_cost(plans):
        t0 = time.perf_counter()
        out = run_batch(store, plan, dev, device_threshold)
        if out is None:
            leftover.extend(idxs)
            continue
        # the group's own prior, under its launch shape: what orders the
        # next batches' groups and gates their small ones
        costprior.learn_group(_plan_shape(plan),
                              (time.perf_counter() - t0) * 1e6)
        for i, o in zip(idxs, out):
            results[i] = o
    eng = Engine(store, device=dev, device_threshold=device_threshold,
                 mesh=mesh)
    with tracing.span("batch.leftover", queries=len(leftover)):
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
    # launch gate: past here the depth-hop run is queued on the device;
    # the budget is checked before, not inside it
    deadline.checkpoint("kernel")
    METRICS.inc("kernel_group_launches_total", family="recurse")
    METRICS.inc("kernel_group_queries_total", float(len(plan.blocks)),
                family="recurse")
    METRICS.inc("kernel_padded_lanes_total", float(B - len(seeds)),
                family="recurse")
    _note_kernel_features(plan.attr, "recurse", B, B - len(seeds),
                          plan.depth, len(plan.blocks))
    costprofile.note_max("bucket_mix", len(g.parts))
    t_exec = time.perf_counter()
    with tracing.span("batch.recurse_run", attr=plan.attr,
                      depth=plan.depth, queries=len(plan.blocks),
                      lanes=B):
        lkey = (plan.attr, plan.reverse, int(mask0.shape[1]), plan.depth,
                g.n)

        def _launch():
            fn = _recurse_for(store, plan.attr, plan.reverse,
                              mask0.shape[1], dev)
            # the seed mask is donated to the run (ops/bfs.py): a fresh
            # device copy per attempt, so a retry starts from the seeds
            _last, _seen, _edges, hops = fn(put_mask(mask0, dev),
                                            plan.depth, True)
            return hops.cpu().numpy().view(np.uint32)   # [depth, n+1, W]

        # allocation failure: evict to the low watermark and retry once;
        # a second one raises out of the group
        hops = memgov.oom_retry("bfs.ell_recurse", lkey, _launch)
    t_end = time.perf_counter()
    exec_us = (t_end - t_exec) * 1e6
    costprofile.add_kernel("recurse", execute_us=exec_us)
    costprofile.add_tablet_cost(plan.attr, exec_us)
    costprofile.note_launch(t_exec, t_end)
    # gather-traffic model: index reads plus one mask row per padded
    # slot, per hop
    costprofile.add("bytes_gathered",
                    plan.depth * g.padded_edges * (4 + 4 * mask0.shape[1]))
    rel = store.rel(plan.attr, plan.reverse)

    with tracing.span("batch.recurse_rebuild"):
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


def _note_kernel_features(attr: str, family: str, lanes: int,
                          padded: int, depth: int, queries: int) -> None:
    """One group launch's plan features into the request's cost record:
    the shape component joins the record to its digest key; lanes,
    padding and depth are the regressors of the feature fit."""
    costprofile.add_shape(f"{family}:{attr}~d{depth}")
    costprofile.note_max("lanes", lanes)
    costprofile.note_max("depth", depth)
    costprofile.add("padded_lanes", padded)
    costprofile.note_max("padding_frac",
                         int(1000 * padded / max(lanes, 1)))
    costprofile.add("queries", queries)


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
    edges_total = 0
    for q in range(B):
        if p_parts[q]:
            datas[q].edges[0] = (np.concatenate(p_parts[q]),
                                 np.concatenate(c_parts[q]))
            edges_total += len(datas[q].edges[0][0])
        datas[q].all_nodes = np.unique(
            np.concatenate(all_nodes[q])).astype(np.int32)
    if edges_total:
        costprofile.add("edges_traversed", edges_total)
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
        deadline.checkpoint("kernel")
        METRICS.inc("kernel_group_launches_total", family="shortest")
        METRICS.inc("kernel_group_queries_total", float(B),
                    family="shortest")
        METRICS.inc("kernel_padded_lanes_total", float(32 * W - B),
                    family="shortest")
        _note_kernel_features(plan.attr, "shortest", 32 * W, 32 * W - B,
                              plan.depth, B)
        costprofile.note_max("bucket_mix", len(g.parts))
        t_exec = time.perf_counter()
        skey = (plan.attr, plan.reverse, W, plan.first_visit, n)
        unresolved = set(active)
        dst_rows = {q: int(g.new_of_old[int(dst[q])]) for q in active}
        frontier = put_mask(mask0, device)
        seen = put_mask(mask0, device)
        done = 0
        while done < plan.depth and unresolved:
            # budget gate per stage: each block of SHORTEST_STAGE hops
            # is queued on the device as a whole
            deadline.checkpoint("kernel")
            chunk = min(SHORTEST_STAGE, plan.depth - done)
            t_stage = time.perf_counter()

            def _launch(frontier=frontier, seen=seen, chunk=chunk):
                step = _step_for(store, plan.attr, plan.reverse, W,
                                 plan.first_visit, device)
                # the stage updates `seen` in place: it runs on a copy,
                # so a retry starts from the carries it was handed
                out = step(frontier, seen.clone(), chunk)
                return out, out[2].cpu().numpy().view(np.uint32)

            with tracing.span("batch.step_run", attr=plan.attr,
                              hops=chunk, lanes=32 * W):
                (frontier, seen, _hops), hops_np = memgov.oom_retry(
                    "bfs.ell_step", skey, _launch)
            costprofile.note_launch(t_stage, time.perf_counter())
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
        exec_us = (time.perf_counter() - t_exec) * 1e6
        costprofile.add_kernel("shortest", execute_us=exec_us)
        costprofile.add_tablet_cost(plan.attr, exec_us)
        costprofile.add("bytes_gathered",
                        done * g.padded_edges * (4 + 4 * W))

    try:
        order_of = [execution_order(blocks) for blocks in plan.queries]
    except ValueError:
        return None
    out = []
    with tracing.span("batch.shortest_rebuild"):
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
            deadline.checkpoint("bfs")
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

# the runners are closures over their device blocks; a nominal per-entry
# charge keeps the cache byte-governable with honest relative pressure
_KERNEL_NBYTES_EST = 64 << 10


def _per_snapshot(host, attr: str, name: str, kind: str, **kw) -> dict:
    """`host.<attr>`, a per-snapshot cache dict, joined to the memory
    governor as cache `name` at first use (`memgov.govern_dict`: the
    oldest-inserted entry is evicted first). Caller holds `_cache_lock`,
    which the governor's callbacks take too."""
    cache = host.__dict__.get(attr)
    if cache is None:
        cache = host.__dict__[attr] = {}
        memgov.govern_dict(host, attr, name, kind, lock=_cache_lock, **kw)
    return cache


def _ell_cache(host) -> dict:
    return _per_snapshot(host, "_ell_cache", "batch.ell", "host")


def _ell_devs(host) -> dict:
    return _per_snapshot(host, "_ell_devs", "batch.ell_dev", "device",
                         on_evict=_drop_dependent_fns)


def _ell_fns(host) -> dict:
    return _per_snapshot(host, "_ell_fns", "batch.kernel", "host",
                         sizer=lambda v: _KERNEL_NBYTES_EST)


def _fn_pred(fkey) -> tuple:
    """(attr, reverse) of a runner key: recurse runners key (attr,
    reverse, W, device), step runners ("step", attr, reverse, W,
    first_visit, device)."""
    return tuple(fkey[1:3]) if fkey[0] == "step" else tuple(fkey[:2])


def _drop_dependent_fns(host, dkey, value) -> int:
    """Evicting a device ELL also drops the runners whose closures pin
    its tensors, or the memory is never freed. Returns the ELL's bytes.
    Caller holds `_cache_lock`."""
    fns = host.__dict__.get("_ell_fns")
    for fkey in [k for k in fns or () if _fn_pred(k) == tuple(dkey[:2])]:
        del fns[fkey]
    return memgov.estimate_nbytes(value)


def _cache_host(store, attr: str, reverse: bool):
    """Where kernel caches live (reference `engine/batch.py:856`): the
    UNDERLYING immutable snapshot when the view's predicate data IS the
    snapshot's (an ACL view or a routed view is a per-request throwaway:
    caching on it would rebuild and place again per request); the Store
    the Alpha's tablet cache keeps beside a pulled tablet
    (`cluster/routed.py`), so a pulled tablet at an unchanged version is
    built and placed once; the view itself when the data is view-local
    (a predicate an ACL view hides)."""
    base = getattr(store, "_ell_host", store)
    if base is not store:
        pd_view = store.preds.get(attr)
        if pd_view is None:
            return store
        if base.preds.get(attr) is not pd_view:
            pulled = getattr(store, "tablet_host", None)
            host = pulled(attr) if pulled is not None else None
            return host if host is not None else store
    return base


def release_host(host) -> None:
    """Drop every kernel cache a pulled tablet's host holds: its placed
    CSRs (and the programs that read them, through the governor's
    `store.device` dependents), its ELL blocks, their device copies,
    the runners and the tree programs, including the tree programs a
    snapshot keeps over it and another host (`_tree_kernel_for`). The
    Alpha calls it when it drops the tablet (`api.tablet`)."""
    with host._place_lock:
        placed = list(host._device.values())
        host._device.clear()
    for value in placed:
        memgov.GOVERNOR.evicted("store.device", value)
    with _cache_lock:
        for attr in ("_ell_cache", "_ell_devs", "_ell_fns", "_tree_fns",
                     "_tree_devs"):
            cache = host.__dict__.get(attr)
            if cache:
                cache.clear()
        for snap in list(MIXED_TREE_HOSTS):
            for attr in ("_tree_fns", "_tree_devs"):
                cache = snap.__dict__.get(attr, {})
                for key in [k for k in cache if host in k[-1]]:
                    del cache[key]


# snapshots that keep tree programs over a pulled tablet's host and
# their own data (`_tree_kernel_for`): `release_host` purges them
MIXED_TREE_HOSTS: "weakref.WeakSet" = weakref.WeakSet()


def _note_ell_cache(hit: bool) -> None:
    """ell_cache_hit feature bit: 1 only when EVERY ELL lookup of the
    request hit the snapshot cache."""
    rec = costprofile.active()
    if rec is None:
        return
    if not hit:
        rec.note("ell_cache_hit", 0)
    elif "ell_cache_hit" not in rec.vals:
        rec.note("ell_cache_hit", 1)


def _ell_for(store, attr: str, reverse: bool):
    """EllGraph per (snapshot, predicate, direction), built once; None
    when the relation has no edges. A view's readable predicates use
    their snapshot's entries (`_cache_host`)."""
    from dgraph_tpu_torch.ops.bfs import build_ell

    host = _cache_host(store, attr, reverse)
    if getattr(host, "_ell_host", host) is not host:
        # a view's own data (a predicate it hides, which reads as
        # empty): nothing to build, and nothing cached on a per-request
        # view
        return None
    key = (attr, reverse)
    with _cache_lock:
        cache = _ell_cache(host)
        if key in cache:
            _note_ell_cache(hit=True)
        else:
            rel = host.rel(attr, reverse)
            if rel.nnz == 0:
                cache[key] = None
            else:
                _note_ell_cache(hit=False)
                t_build = time.perf_counter()
                with tracing.span("batch.build_ell", pred=attr,
                                  reverse=reverse):
                    cache[key] = build_ell(rel.indptr, rel.indices)
                build_us = (time.perf_counter() - t_build) * 1e6
                costprofile.add("build_us", int(build_us))
                costprofile.add_tablet_cost(attr, build_us)
        out = cache[key]
    memgov.GOVERNOR.maybe_evict("host")
    return out


def _dev_for(store, attr: str, reverse: bool, device):
    """(EllGraph, DeviceEll) per (snapshot, pred, dir, device): the
    index blocks are placed once and shared by every lane width."""
    from dgraph_tpu_torch.ops.bfs import device_ell

    host = _cache_host(store, attr, reverse)
    g = _ell_for(store, attr, reverse)
    key = (attr, reverse, str(device))
    with _cache_lock:
        devs = _ell_devs(host)
        if key not in devs:
            devs[key] = device_ell(g, device)
        out = g, devs[key]
    # the caller holds the blocks it was handed even if this pass evicts
    # them; the next lookup places them again
    memgov.GOVERNOR.maybe_evict("device")
    return out


def _recurse_for(store, attr: str, reverse: bool, W: int, device):
    """Recurse runner per (snapshot, pred, dir, lane width, device)."""
    from dgraph_tpu_torch.ops.bfs import make_ell_recurse

    host = _cache_host(store, attr, reverse)
    key = (attr, reverse, W, str(device))
    with _cache_lock:
        fn = _ell_fns(host).get(key)
    if fn is not None:
        return fn
    g, dev = _dev_for(store, attr, reverse, device)
    with _cache_lock:
        fns = _ell_fns(host)
        if key not in fns:
            fns[key] = make_ell_recurse(dev, g.outdeg, g.n, W,
                                        count_edges=False)
        return fns[key]


def _step_for(store, attr: str, reverse: bool, W: int, first_visit: bool,
              device):
    """Resumable hop block per (snapshot, pred, dir, lane width, family,
    device) — the staged shortest path's program."""
    from dgraph_tpu_torch.ops.bfs import make_ell_step

    host = _cache_host(store, attr, reverse)
    key = ("step", attr, reverse, W, first_visit, str(device))
    with _cache_lock:
        fn = _ell_fns(host).get(key)
    if fn is not None:
        return fn
    g, dev = _dev_for(store, attr, reverse, device)
    with _cache_lock:
        fns = _ell_fns(host)
        if key not in fns:
            fns[key] = make_ell_step(dev, g.n, W, first_visit=first_visit)
        return fns[key]


def carry_kernel_caches(old_store, new_store, touched) -> int:
    """Hand a folded snapshot the kernel caches of the predicates the
    folded layers left untouched (reference `engine/batch.py:1002`): over
    the same vocabulary such a predicate folds to identical CSR arrays, so
    the old snapshot's ELL blocks (`_ell_cache`), their device copies
    (`_ell_devs`, the same tensors) and the runners built over them
    (`_ell_fns`) stay valid, and so do the mesh-sharded tablets
    (`carry_mesh_residency`). Nothing is copied and nothing is built.
    The whole-block programs and the per-predicate CSR tensors are not
    carried: they start empty on the new snapshot, as in the reference.
    Returns how many (predicate, direction) entries carried, and counts
    them in `ell_cache_carried_total`."""
    if old_store is new_store or old_store is None or new_store is None:
        return 0
    if getattr(old_store, "n_nodes", -1) != \
            getattr(new_store, "n_nodes", -2):
        return 0
    if not np.array_equal(old_store.uids, new_store.uids):
        return 0
    carry_mesh_residency(old_store, new_store, touched)
    carried = 0
    with _cache_lock:
        src_cache = old_store.__dict__.get("_ell_cache")
        if not src_cache:
            return 0
        dst_cache = _ell_cache(new_store)
        src_devs = old_store.__dict__.get("_ell_devs", {})
        src_fns = old_store.__dict__.get("_ell_fns", {})
        dst_devs = _ell_devs(new_store)
        dst_fns = _ell_fns(new_store)
        for key, g in src_cache.items():
            attr, reverse = key
            if attr in touched or key in dst_cache:
                continue
            dst_cache[key] = g
            for dkey, dev in src_devs.items():
                if dkey[:2] == key:
                    dst_devs.setdefault(dkey, dev)
            for fkey, fn in src_fns.items():
                if _fn_pred(fkey) == key:
                    dst_fns.setdefault(fkey, fn)
            carried += 1
    if carried:
        METRICS.inc("ell_cache_carried_total", float(carried))
    return carried


def carry_mesh_residency(old_store, new_store, touched) -> int:
    """Hand a folded snapshot the mesh-sharded tablets
    (`Store.sharded_rel`) of the predicates the folded layers left
    untouched, for the same mesh: such a predicate folds to the same
    CSR, so its placed shard stack stays valid and the serving path
    never places a resident tablet again because of an unrelated fold.
    A touched predicate starts unplaced on the new snapshot. Returns how
    many (predicate, direction) entries carried, counted in
    `mesh_resident_carried_total`."""
    src = getattr(old_store, "_sharded", None)
    if not src or not hasattr(new_store, "_sharded"):
        return 0
    mesh = old_store._sharded_mesh
    carried = 0
    with new_store._place_lock:
        if new_store._sharded_mesh is not mesh:
            new_store._sharded = {}
            new_store._sharded_mesh = mesh
        dst = new_store._sharded
        for key, srel in list(src.items()):
            if key[0] in touched or key in dst:
                continue
            dst[key] = srel
            carried += 1
    if carried:
        METRICS.inc("mesh_resident_carried_total", float(carried))
    return carried
