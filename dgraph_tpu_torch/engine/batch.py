"""Batched @recurse serving: many concurrent queries, ONE lane kernel run.

Port of the recurse family of `dgraph_tpu/engine/batch.py` plus the
batch half of `Alpha.query_batch` (`dgraph_tpu/server/api.py`):
structurally compatible `@recurse` queries are packed into the bit-lanes
of one frontier mask and answered by one multi-hop run of
`ops/bfs.py:make_ell_recurse` (every bucket of every hop on the CUDA
bucket-hop kernel), then rebuilt into per-query trees and rendered to
JSON by the standard renderer.

Queries that no recurse group takes (ineligible, in a group below
MIN_BATCH, unparsable, or over a predicate with no edges in the group's
direction) are served one by one by the per-query `Engine` on the same
device, as the reference's `Alpha.query_batch` falls back; a query that
fails there yields an error object in its slot. One deliberate
difference from the reference: a failing kernel group is not caught.
Level trees, filtered recurse and shortest-path groups are later slices
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import threading

import numpy as np

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


class _BatchPlan:
    def __init__(self, blocks, attr, reverse, depth):
        self.blocks = blocks          # one root SubGraph per query
        self.attr = attr
        self.reverse = reverse
        self.depth = depth


def _expands(store, c: SubGraph) -> bool:
    return _expands_schema(store.schema, c)


def _eligible(store, blocks):
    """(signature, root_sg) when the query fits the lane kernel, else
    None. The signature is what must MATCH across a kernel launch."""
    if len(blocks) != 1:
        return None
    sg = blocks[0]
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


def plan_batch(store, queries_blocks):
    """A plan only when EVERY query fits one lane-kernel launch."""
    plans, leftover = plan_batch_groups(store, queries_blocks)
    if len(plans) == 1 and not leftover:
        return plans[0][0]
    return None


def plan_batch_groups(store, queries_blocks):
    """Split a batch into recurse kernel groups:
    ([(plan, original_indices)], leftover_indices). Groups smaller than
    MIN_BATCH join the leftovers (the reference's count rule; its
    cost-prior override is not ported)."""
    groups: dict = {}
    leftover: list[int] = []
    for i, blocks in enumerate(queries_blocks):
        er = _eligible(store, blocks)
        if er is not None:
            groups.setdefault(er[0], []).append((i, er[1]))
        else:
            leftover.append(i)
    plans = []
    for sig, items in groups.items():
        if len(items) < MIN_BATCH:
            leftover.extend(i for i, _ in items)
        else:
            plans.append((_BatchPlan([sg for _, sg in items],
                                     sig[0], sig[1], sig[2]),
                          [i for i, _ in items]))
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
    """Serve many queries at once: each compatible @recurse group is ONE
    lane-packed kernel run on `device`; the rest go through the
    per-query Engine on the same device, whose failures become
    `{"errors": [{"message": ...}]}` in their slot. Returns one JSON
    dict per query, in order."""
    from dgraph_tpu_torch.engine import Engine

    dev = resolve_device(device)
    plans, leftover = plan_batch_groups_cached(store, dqls)
    leftover = list(leftover)        # the cached list is never mutated
    results: list = [None] * len(dqls)
    for plan, idxs in plans:
        out = run_batch(store, plan, dev)
        if out is None:
            leftover.extend(idxs)
            continue
        for i, o in zip(idxs, out):
            results[i] = o
    eng = Engine(store, device=dev, device_threshold=device_threshold)
    for i in sorted(leftover):
        try:
            results[i] = eng.query(dqls[i])
        except (ValueError, NotImplementedError) as e:
            results[i] = {"errors": [{"message": str(e)}]}
    return results


def run_batch(store, plan: _BatchPlan, device=DEFAULT_DEVICE) -> list:
    """Execute one recurse group as one lane-kernel run and render each
    query with the standard renderer; None when the predicate has no
    edges in the group's direction (the per-query engine serves it)."""
    dev = resolve_device(device)
    g = _ell_for(store, plan.attr, plan.reverse)
    if g is None:
        return None
    from dgraph_tpu_torch.ops.bfs import pack_seed_masks, put_mask

    # root seed ranks per query (host index lookups). Lane words round
    # UP to a power of two: padding lanes are zero-seeded and free
    ex0 = Executor(store, device=dev)
    seeds = [ex0.root_ranks(sg) for sg in plan.blocks]
    B = _lane_count(len(seeds))
    seed_lists = seeds + [np.zeros(0, np.int32)] * (B - len(seeds))
    mask0 = pack_seed_masks(g, seed_lists)
    fn = _recurse_for(store, plan.attr, plan.reverse, mask0.shape[1], dev)
    # the seed mask is donated to the run (ops/bfs.py): a fresh device
    # copy per launch
    _last, _seen, _edges, hops = fn(put_mask(mask0, dev), plan.depth, True)
    hops = hops.cpu().numpy().view(np.uint32)     # [depth, n+1, W]
    rel = store.rel(plan.attr, plan.reverse)

    root_nodes = [np.unique(s).astype(np.int32) for s in seeds]
    datas = _rebuild_recurse_batch(store, g, rel, hops, plan.blocks,
                                   root_nodes)
    out = []
    for q, sg in enumerate(plan.blocks):
        ex = Executor(store, device=dev)
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
