"""Whole-query fusion: one device program per eligible root block.

Port of `dgraph_tpu/engine/fused.py`, with all five of its stage kinds:
hop, recurse, count, knn and featprop.

`plan_block` walks a parsed root block into a `FusedPlan` of stages in
DFS pre-order: hop levels (the segment-CSR gather of `ops/hop.py` and
the filter + paginate body of `ops/level.py`, each consuming the
previous stage's deduped frontier), a visit-once `@recurse` as `depth`
masked hops (`ops/recurse.masked_hop`, per-hop edge matrices kept for
rendering), terminal `count(pred)` degree reductions, a `similar_to`
seed stage (`store/vec.device_topk` on the tablet's tensors, emitting the
root frontier inside the program) and an `@msgpass` featprop stage over a
recurse stage's per-hop edge matrices (one `ops/feat.segment_combine`
kernel launch per hop). Filter trees evaluate on the host to sorted
allowed sets up front; a knn stage's query vector rides the packed input
as float32 bits.

`_build_program` closes over the static plan and returns a plain
function that runs the stages eagerly on torch tensors: the program's
plain version, which is what `device="cpu"` runs. On the card the first
call for a key whose caps hold (no overflow in an eager warm-up on a
side stream) captures that function once into a `torch.cuda.CUDAGraph`;
later calls copy the packed inputs (root frontier, allowed sets, page
windows: one int32 buffer, one host-to-device copy) into the graph's
static buffer and call `replay()`. The key is (store, plan signature,
caps, root-frontier bucket, allowed-set buckets, device), where the
store is an ACL view's snapshot when the view reads the snapshot's data.
Captures serialize under `utils/device.DEVICE_WIDE` and are
thread-local, so concurrent HTTP request threads serve while one
captures (see `_Program._capture`). The graph's
outputs are overwritten by its next replay, so a call copies what it
needs to the host under the program's lock: first the packed sizes (one
small copy, the overflow check), then the kept rows.

Caps follow the ops' overflow contract: estimated from root degrees and
average degrees, checked against the true sizes the program reports,
regrown geometrically on overflow (`_MAX_ATTEMPTS`), and memoized per
plan signature; each new set of caps is a new program and capture. The
program memo is an LRU of at most `PROGRAM_CAPACITY` programs whose
graphs reserve at most `PROGRAM_BYTES` of device memory in all (each
capture's growth of `torch.cuda.memory_reserved`). It is also the
memory governor's `fused.program` cache (utils/memgov.py), charged those
graph bytes against the device budget: with a budget set, the governor
evicts programs below the memo's own bounds. An evicted program that a
call still holds stays alive (graph, pool, static buffers and the CSR
tensors it reads) until that call has copied its outputs out; the memo
only drops its reference. A program holds its store's CSR tensors; the
programs of a store that was collected are dropped at the next call,
and so are those that read a `store.device` CSR or `store.vec` stack
the governor evicted (a memo hit whose tensors are no longer the
store's is built again).

Each call runs under the governor's allocation-failure lifecycle at site
`fused.program`, keyed by query shape: a `torch.cuda.OutOfMemoryError`
(in a placement, the warm-up, the capture or a replay) evicts to the
low watermark and runs the call once more; an allocation failure during
a capture first discards the half-captured graph and its pool, so no
dead pool is counted. A second allocation failure degrades the shape:
the staged torch ops serve it on the same card until the governor's
degraded set is reset. Any other failure of a program on the card
raises, as a failing kernel does on the staged route: nothing moves work
off the card quietly. On the CPU a block whose program fails is served
by the staged route from then on (sticky per query shape, until
`reset()`); every such fallback is logged with its traceback and
counted in `status()`, beside the routes taken, program hits and
misses, captures, capture milliseconds and the bytes the graphs hold.
Each capture's time is the `fused` family's compile µs in the request's
cost record (utils/costprofile.py), each call its execute µs and one
launch. Routes, fallbacks, hits and misses also count in
the metrics registry under the reference's names (`fused_route_total`,
`fused_fallback_total`, `fused_program_{hits,misses}_total`).
`DGRAPH_TPU_FUSED=0` pins every block to the staged route. The host
shell runs in the `engine.fused` span, and checks the request's deadline
("kernel") before each call of a program: between replays, never inside
a capture.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch.engine.execute import EMPTY, LevelNode, _bucket, expands
from dgraph_tpu_torch.engine.feat import AGGS, count_route, feat_key
from dgraph_tpu_torch.engine.recurse import (RecurseData, _bind_recurse_vars,
                                             split_children)
from dgraph_tpu_torch.ops import feat as feat_ops
from dgraph_tpu_torch.ops.hop import frontier_degrees, gather_edges
from dgraph_tpu_torch.ops.level import NO_LIMIT, filter_paginate
from dgraph_tpu_torch.ops.recurse import masked_hop, seen_bitmap
from dgraph_tpu_torch.ops.uidalgebra import sentinel, sort_unique_count
from dgraph_tpu_torch.store import vec
from dgraph_tpu_torch.store.types import Kind
from dgraph_tpu_torch.store.vec import device_topk
from dgraph_tpu_torch.utils import costprofile, memgov, tracing
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.device import DEVICE_WIDE
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["STAGE_KINDS", "FusedPlan", "enabled", "plan_block",
           "try_fused", "status", "reset", "captured"]

STAGE_KINDS: dict[str, str] = {
    "hop": ("one child level: segment-CSR gather + fused filter mask "
            "+ on-device pagination + dedupe into the next frontier"),
    "recurse": ("depth-bounded visit-once @recurse as `depth` masked "
                "hops over an int8 seen bitmap, per-hop edge matrices "
                "kept"),
    "count": ("terminal count(pred) aggregation: per-parent-node "
              "degree bound to the leaf's value var"),
    "knn": ("similar_to seed selection: scored GEMV over the vector "
            "tablet + exact top-k (tie-break by rank) emitting the root "
            "frontier inside the program"),
    "featprop": ("@msgpass feature propagation over a recurse stage: "
                 "per-hop segment combine (sum/mean/max) of the kept "
                 "edges' neighbour feature rows against the tablet"),
}

MAX_FUSED_DEPTH = 64     # depth bound for the recurse stage
_MAX_ATTEMPTS = 16       # geometric cap growth, bounded
PROGRAM_CAPACITY = 128   # programs (and their graphs) kept, LRU
PROGRAM_BYTES = 2 << 30  # device memory the kept graphs may reserve

_log = logging.getLogger("dgraph_tpu_torch.engine.fused")


def enabled() -> bool:
    """Default-on: DGRAPH_TPU_FUSED=0 pins every block to the staged
    route. Read per call, so a run can switch it between queries."""
    return os.environ.get("DGRAPH_TPU_FUSED", "1") != "0"


@dataclass(frozen=True)
class _Stage:
    kind: str            # STAGE_KINDS key
    attr: str
    reverse: bool
    parent: int          # producing stage index; -1 = the root frontier
    has_filter: bool = False
    depth: int = 0       # recurse only
    k: int = 0           # knn only: requested seed count
    agg: str = ""        # featprop only: sum | mean | max

    def sig(self) -> tuple:
        return (self.kind, self.attr, self.reverse, self.parent,
                self.has_filter, self.depth, self.k, self.agg)


@dataclass
class FusedPlan:
    """Stages in DFS pre-order (parents before children: the order
    `Executor._descend` runs them)."""

    stages: list[_Stage] = field(default_factory=list)
    stage_sgs: list = field(default_factory=list)   # SubGraph per stage
    children_of: dict[int, list[int]] = field(default_factory=dict)
    # parent stage idx → {id(leaf sg): count stage idx}
    counts_of: dict[int, dict[int, int]] = field(default_factory=dict)
    recurse: bool = False
    knn: bool = False       # stage 0 is a knn seed stage
    featprop: bool = False  # an @msgpass stage follows the recurse stage

    @property
    def sig(self) -> tuple:
        return tuple(st.sig() for st in self.stages)


class _Ineligible(Exception):
    pass


def _filter_fusable(tree) -> bool:
    """Whether a filter tree evaluates to a host allowed set that can
    fuse into the gather mask: no complement (`not` needs a universe),
    and no leaves reading variables that could be bound inside this
    block (the staged route evaluates them mid-descent; the program
    takes every allowed set up front)."""
    if tree is None:
        return True
    if tree.op == "not":
        return False
    if tree.op == "leaf":
        f = tree.func
        if f.is_val_var:
            return False
        if f.name == "uid" and f.args:
            return False
        return True
    return all(_filter_fusable(c) for c in tree.children)


def _stage_ok(c) -> bool:
    """Per-child eligibility for a hop stage: everything needing
    per-edge host logic mid-descent stays staged."""
    return not (c.recurse is not None or c.shortest is not None
                or c.msgpass is not None
                or c.groupby or c.is_expand_all
                or c.orders or c.facet_orders or c.after
                or c.facet_vars is not None or c.facet_filter is not None
                or not _filter_fusable(c.filters))


def plan_block(store, sg) -> FusedPlan | None:
    """Walk one parsed root block into a FusedPlan, or None when any
    part needs the staged route."""
    if sg.shortest is not None or sg.groupby:
        return None

    knn_stage = _plan_knn(store, sg)

    if sg.recurse is not None:
        a = sg.recurse
        if a.loop or not a.depth or a.depth > MAX_FUSED_DEPTH:
            return None
        edge = [c for c in sg.children if expands(store.schema, c)]
        if len(edge) != 1:
            return None
        e = edge[0]
        if (e.is_expand_all or e.facet_filter is not None
                or e.msgpass is not None
                or not _filter_fusable(e.filters)):
            return None
        plan = FusedPlan(recurse=True, knn=knn_stage is not None)
        if knn_stage is not None:
            plan.stages.append(knn_stage)
            plan.stage_sgs.append(sg)
        plan.stages.append(_Stage("recurse", e.attr, e.is_reverse,
                                  0 if plan.knn else -1,
                                  e.filters is not None, a.depth))
        plan.stage_sgs.append(e)
        if sg.msgpass is not None:
            fp = _plan_featprop(store, sg.msgpass, len(plan.stages) - 1)
            if fp is None:
                return None   # the staged route serves (and raises)
            plan.stages.append(fp)
            plan.stage_sgs.append(sg)
            plan.featprop = True
        return plan

    if sg.msgpass is not None:
        # plain-level @msgpass aggregates on the host after the staged
        # descent
        return None

    plan = FusedPlan(knn=knn_stage is not None)
    root_parent = -1
    if knn_stage is not None:
        plan.stages.append(knn_stage)
        plan.stage_sgs.append(sg)
        root_parent = 0

    def walk(node_sg, parent: int) -> None:
        for c in node_sg.children:
            if expands(store.schema, c):
                if not _stage_ok(c):
                    raise _Ineligible
                i = len(plan.stages)
                plan.stages.append(_Stage("hop", c.attr, c.is_reverse,
                                          parent, c.filters is not None))
                plan.stage_sgs.append(c)
                plan.children_of.setdefault(parent, []).append(i)
                walk(c, i)
            elif (c.is_count and not c.is_uid_leaf and c.var_name
                  and c.attr):
                i = len(plan.stages)
                plan.stages.append(_Stage("count", c.attr,
                                          c.is_reverse, parent))
                plan.stage_sgs.append(c)
                plan.counts_of.setdefault(parent, {})[id(c)] = i
            # other leaves (values, vars, aggregates) bind on the host

    try:
        walk(sg, root_parent)
    except _Ineligible:
        return None
    if not plan.knn and not any(st.kind == "hop" for st in plan.stages):
        return None    # nothing device-bound to fuse
    return plan


def _plan_knn(store, sg) -> _Stage | None:
    """A similar_to root becomes a knn seed stage when the root level is
    plain: root filters, ordering and pagination reorder or trim the seed
    set on the host, so those shapes keep the staged seed. k must be a
    positive int at plan time; the query vector resolves at run time."""
    f = sg.func
    if f is None or f.name != "similar_to":
        return None
    if (sg.filters is not None or sg.orders or sg.first or sg.offset
            or sg.after):
        return None
    ps = store.schema.peek(f.attr)
    if ps is None or ps.kind != Kind.VECTOR:
        return None
    try:
        k = int(f.args[0])
    except (IndexError, TypeError, ValueError):
        return None    # malformed: the staged route raises the error
    if k <= 0 or len(f.args) != 2:
        return None
    return _Stage("knn", f.attr, False, -1, False, 0, k)


def _plan_featprop(store, mp, recurse_idx: int) -> _Stage | None:
    """@msgpass on a fused recurse block becomes a featprop stage when
    the feature predicate is a vector and the agg one the kernel
    computes; anything else keeps the staged route, which raises the
    user-facing errors."""
    if mp.agg not in AGGS:
        return None
    ps = store.schema.peek(mp.pred)
    if ps is None or ps.kind != Kind.VECTOR:
        return None
    return _Stage("featprop", mp.pred, False, recurse_idx, False, 0, 0,
                  mp.agg)


# -- the program ----------------------------------------------------------------
# one emitter per STAGE_KINDS entry, called with the stage, its caps, its
# tensors (a CSR pair or a tablet's (subj, vecs)), its allowed set (a knn
# stage's query-vector bits), its page, its input frontier and its parent
# stage's outputs. Each returns (outputs, sizes, next_frontier): `outputs`
# slot for slot the reference program's, and `sizes` the int32 counts the
# host reads back first (overflow checks, slice lengths).

def _emit_hop(st: _Stage, caps: tuple, rel, allowed, page, frontier,
              parent_out):
    (indptr, indices), (offset, first) = rel, page
    (edge_cap,) = caps
    nbrs, seg, pos, valid, total = gather_edges(
        indptr, indices, frontier, edge_cap)
    c_nbrs, c_seg, c_pos, n_kept, m_nbrs = filter_paginate(
        nbrs, seg, pos, valid, allowed, offset, first,
        frontier.shape[0], st.has_filter)
    # the next frontier dedupes the kept edges (post filter + page): the
    # set the staged route's np.unique(nbrs) gives; it cannot overflow
    # edge_cap, so out_cap == edge_cap
    nxt, n_unique = sort_unique_count(m_nbrs, edge_cap)
    return ((c_nbrs, c_seg, c_pos, n_kept, nxt, n_unique, total),
            torch.stack([n_kept, n_unique, total]), nxt)


def _emit_recurse(st: _Stage, caps: tuple, rel, allowed, page, frontier,
                  parent_out):
    """`depth` masked hops with the seen bitmap on the device, per-hop
    edge matrices and input frontiers kept for host rendering."""
    indptr, indices = rel
    edge_cap, out_cap = caps
    if frontier.shape[0] < out_cap:
        # knn-fed: the seed stage's cap is narrower than the hop's frontier
        # buffer; sentinel padding keeps a sorted set sorted
        frontier = torch.cat([frontier, torch.full(
            (out_cap - frontier.shape[0],), sentinel(frontier.dtype),
            dtype=frontier.dtype, device=frontier.device)])
    seen = seen_bitmap(indptr.shape[0] - 1, frontier)
    hops = []
    fr = frontier
    for _ in range(st.depth):
        c_nbrs, c_seg, n_kept, nxt, n_unique, seen, total = masked_hop(
            indptr, indices, fr, allowed, seen, edge_cap, out_cap,
            st.has_filter)
        hops.append((c_nbrs, c_seg, n_kept, fr, n_unique, total))
        fr = nxt
    nbrs_h, seg_h, kept_h, fr_h, uniq_h, tot_h = (
        torch.stack(col) for col in zip(*hops))
    # tot_h/uniq_h are the per-hop true sizes: their maxima are the
    # overflow contract's needs, their sum the edges traversed
    return ((nbrs_h, seg_h, kept_h, fr_h, tot_h, uniq_h),
            torch.cat([kept_h, uniq_h, tot_h]), None)


def _emit_count(st: _Stage, caps: tuple, rel, allowed, page, frontier,
                parent_out):
    """Per-parent-node degree of the counted predicate, aligned to the
    parent's padded node array."""
    return (frontier_degrees(rel[0], frontier),), None, None


def _emit_knn(st: _Stage, caps: tuple, rel, allowed, page, frontier,
              parent_out):
    """The similar_to seed stage: the k best rows of the tablet, as a
    sorted sentinel-padded rank set the next stage takes as its frontier.
    The query vector is the allowed slot's first d words, as float32."""
    subj, vecs = rel
    (out_cap,) = caps
    q = allowed[:vecs.shape[1]].view(torch.float32)
    nxt = device_topk(subj, vecs, q, st.k, out_cap)
    return (nxt,), None, nxt


def _emit_featprop(st: _Stage, caps: tuple, rel, allowed, page, frontier,
                   parent_out):
    """The @msgpass stage: one segment combine per hop of the recurse
    stage's kept-edge matrices, segments the hop's input-frontier
    positions. A hop's kept edges come in frontier order (seg is
    non-decreasing), so no grouping sort runs. Visit-once expansion puts
    each parent's whole edge set in exactly one hop, so the per-hop
    combine equals the staged route's global one."""
    subj, vecs = rel
    nbrs_h, seg_h, kept_h, fr_h, _tot, _uniq = parent_out
    out_cap = fr_h.shape[1]
    per_hop = [feat_ops.segment_combine(subj, vecs, nbrs_h[h], seg_h[h],
                                        kept_h[h], out_cap, st.agg,
                                        seg_sorted=True)
               for h in range(nbrs_h.shape[0])]
    feats, cnt, ecnt = (torch.stack(col) for col in zip(*per_hop))
    return (feats, cnt, ecnt), None, None


_STAGE_EMITTERS = {
    "hop": _emit_hop,
    "recurse": _emit_recurse,
    "count": _emit_count,
    "knn": _emit_knn,
    "featprop": _emit_featprop,
}


def _build_program(stages: tuple, caps: tuple, layout: tuple):
    """Close over the static plan and return the whole-block program as
    a plain function `program(rels, flat) -> (outputs, sizes)`: `rels`
    holds each stage's (indptr, indices); `flat` is the packed int32
    input (`_pack`: root frontier, each stage's allowed set, each
    stage's (offset, first)), cut by the static `layout`."""
    f_cap, a_caps = layout
    a_offs = np.concatenate([[f_cap], f_cap + np.cumsum(a_caps)]).tolist()
    p0 = a_offs[-1]

    def program(rels, flat):
        outs, sizes = [], []
        stage_frontier = [None] * len(stages)
        for i, st in enumerate(stages):
            fr = flat[:f_cap] if st.parent < 0 else stage_frontier[st.parent]
            allowed = flat[a_offs[i]:a_offs[i + 1]]
            page = (flat[p0 + 2 * i], flat[p0 + 2 * i + 1])
            out, size, nxt = _STAGE_EMITTERS[st.kind](
                st, caps[i], rels[i], allowed, page, fr,
                outs[st.parent] if st.parent >= 0 else None)
            outs.append(out)
            if size is not None:
                sizes.append(size)
            stage_frontier[i] = nxt
        if not sizes:    # knn and count stages only
            sizes.append(flat[:0])
        return tuple(outs), torch.cat(sizes)

    return program


def _pack(nodes: np.ndarray, f_cap: int, alloweds, pages):
    """The packed int32 input of one call and its layout: the root
    frontier and each allowed set sentinel-padded to their buckets, then
    each stage's (offset, first)."""
    snt = sentinel(torch.int32)
    a_caps = tuple(_bucket(max(len(a), 1)) for a in alloweds)
    flat = np.full(f_cap + sum(a_caps) + 2 * len(pages), snt, np.int32)
    flat[:len(nodes)] = nodes
    off = f_cap
    for a, cap in zip(alloweds, a_caps):
        flat[off:off + len(a)] = a
        off += cap
    flat[off:] = np.asarray(pages, np.int32).ravel()
    return flat, (f_cap, a_caps)


class _Program:
    """One program: its plain function and, on the card, the graph
    captured from it with the static input buffer and outputs the graph
    reads and writes. `lock` is held from a call's input copy until its
    outputs are on the host. `stages`, `caps`, `layout` and `last`
    (the last call's per-stage sizes and root count) let a caller
    account for the work of a call; `combines` is the number of
    segment_combine launches in one replay, counted on each."""

    def __init__(self, fn, rels, device: torch.device, stages: tuple,
                 caps: tuple, layout: tuple):
        self.fn = fn
        self.rels = rels            # the CSR tensors the graph reads
        self.device = device
        self.stages, self.caps, self.layout = stages, caps, layout
        self.lock = threading.Lock()
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.graph_bytes = 0        # memory_reserved growth of the capture
        self.capture_us = 0.0       # what capturing it again would cost
        self.held = True            # in the memo (False once dropped)
        self.last = None            # (split sizes, roots) of the last call
        self.combines = 0           # segment_combine calls the graph holds

    def run(self, flat: np.ndarray, fits):
        """(sizes on the host, outputs on the device) of one call.
        `fits(sizes)` says whether these caps held; caps that overflow in
        the warm-up are never captured."""
        x = torch.from_numpy(flat)
        if self.device.type != "cuda":
            outs, sizes = self.fn(self.rels, x)
            return sizes.numpy(), outs
        if self.graph is None:
            # the warm-up and the capture hold DEVICE_WIDE: every
            # capture takes its class's one capture stream, and the
            # warm-up's side stream comes from PyTorch's round-robin
            # pool, which can hand out that very stream; a warm-up on
            # it while another thread captures joins or breaks that
            # capture. Other request threads' work (the default stream)
            # goes on meanwhile.
            with DEVICE_WIDE:
                sizes, outs = self._warm_up(x)
                if not fits(sizes):
                    return sizes, outs
                self._capture()
            # the graph's memory now counts against the device budget
            memgov.GOVERNOR.maybe_evict("device")
        self.static_in.copy_(x)
        self.graph.replay()
        if self.combines:
            feat_ops.count_replay(self.combines)
        outs, sizes = self.static_out
        return sizes.cpu().numpy(), outs

    def _warm_up(self, x: torch.Tensor):
        """One eager run on a side stream (lazy initialisation and the
        allocator's first blocks happen outside capture)."""
        self.static_in = x.to(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            outs, sizes = self.fn(self.rels, self.static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        return sizes.cpu().numpy(), outs

    def _capture(self) -> None:
        """Capture `fn` into a graph; the caller holds `DEVICE_WIDE`, so
        no other capture or warm-up, `empty_cache` or device-wide
        `synchronize` runs while it is underway (utils/device.py).
        Other request threads keep serving: the capture is thread-local,
        so their launches, copies and allocations on the default stream
        neither join nor invalidate it."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        recorded = feat_ops.RECORDED["segment_combine"]
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                # read after the context's own empty_cache(), which would
                # otherwise hide the pool's growth (other threads'
                # allocations meanwhile count in it too)
                before = torch.cuda.memory_reserved(self.device)
                self.static_out = self.fn(self.rels, self.static_in)
        except BaseException as e:
            # a failed capture (an allocation failure among them) leaves
            # a half-captured graph and its private pool: discard both,
            # so a retry captures afresh and no dead pool is counted
            self.static_out = None
            try:
                graph.reset()
            except RuntimeError:
                pass
            del graph
            torch.cuda.empty_cache()
            first = e.__context__
            if not memgov.is_alloc_failure(e) and \
                    memgov.is_alloc_failure(first):
                # ending a capture that an allocation failure cut short
                # can fail in turn: the allocation failure is the cause
                raise first from e
            raise
        self.graph = graph
        self.combines = feat_ops.RECORDED["segment_combine"] - recorded
        self.graph_bytes = max(
            torch.cuda.memory_reserved(self.device) - before, 0)
        capture_us = self.capture_us = (time.perf_counter() - t0) * 1e6
        costprofile.add_kernel("fused", compile_us=capture_us)
        with _lock:
            _stats["captures"] += 1
            _stats["capture_ms"] += capture_us / 1e3
            if self.held:
                _stats["program_bytes"] += self.graph_bytes
                _evict()


# -- program and caps memos, counters --------------------------------------------

_lock = threading.Lock()
_programs: OrderedDict = OrderedDict()   # key → _Program (LRU, under _lock)
_caps_memo: dict = {}     # plan sig → last good caps (under _lock)
_disabled: set = set()    # query shapes pinned to the staged route
_stores: dict = {}        # id(store) → its finalizer, while it lives
_collected: list = []     # ids of collected stores (appended by GC)


def _fresh_stats() -> dict:
    return {"routes": {"fused": 0, "staged": 0, "fallback": 0},
            "fallbacks": 0, "hits": 0, "misses": 0, "captures": 0,
            "capture_ms": 0.0, "program_bytes": 0, "evictions": 0}


_stats = _fresh_stats()


def _route(route: str) -> None:
    with _lock:
        _stats["routes"][route] += 1
    METRICS.inc("fused_route_total", route=route)


def _store_key(store) -> int:
    """The store's part of a program key. The programs of a store hold
    its CSR tensors; once the store is collected, the next call drops
    them (a finalizer only records the id: it may run inside a locked
    section)."""
    sid = id(store)
    with _lock:
        _evict()     # first: a collected store's id may be reused
        if sid not in _stores:
            _stores[sid] = weakref.finalize(store, _collected.append, sid)
    return sid


def _evict() -> None:
    """Drop the programs of collected stores, then the least recently
    used until the memo holds `PROGRAM_CAPACITY` programs and
    `PROGRAM_BYTES` of graph memory (the newest program stays). Under
    `_lock`."""
    while _collected:
        sid = _collected.pop()
        _stores.pop(sid, None)
        for key in [k for k in _programs if k[0] == sid]:
            _drop(key)
    while len(_programs) > 1 and (len(_programs) > PROGRAM_CAPACITY
                                  or _stats["program_bytes"] > PROGRAM_BYTES):
        _drop(next(iter(_programs)))


def _drop(key) -> None:
    prog = _programs.pop(key)
    prog.held = False
    _stats["program_bytes"] -= prog.graph_bytes
    _stats["evictions"] += 1


def _governed_bytes() -> int:
    with _lock:
        return _stats["program_bytes"]


def _coldest():
    """(key, program) of the least recently used program that holds
    graph memory, or None. Under `_lock`."""
    return next(((k, p) for k, p in _programs.items() if p.graph_bytes),
                None)


def _evict_one() -> int:
    """The governor's eviction: drop the least recently used program
    that holds graph memory; returns its graph bytes (0: none holds
    any)."""
    with _lock:
        cold = _coldest()
        if cold is None:
            return 0
        _drop(cold[0])
        return cold[1].graph_bytes


def _coldest_value() -> float | None:
    """Capture µs per graph byte of the program `_evict_one` would drop:
    the governor evicts cheaper caches first (the reference prices its
    program memo by compile µs per byte the same way)."""
    with _lock:
        cold = _coldest()
    if cold is None:
        return None
    return cold[1].capture_us / cold[1].graph_bytes


def _drop_holding(value) -> None:
    """A `store.device` CSR or `store.vec` stack was evicted: drop the
    programs whose graphs read its tensors, or evicting it frees no
    memory and its next placement is a second copy."""
    with _lock:
        for key in [k for k, p in _programs.items()
                    if any(r is value for r in p.rels)]:
            _drop(key)


memgov.GOVERNOR.register("fused.program", "device", _governed_bytes,
                         _evict_one, value_cb=_coldest_value)
memgov.GOVERNOR.add_dependent("store.device", _drop_holding)
memgov.GOVERNOR.add_dependent("store.vec", _drop_holding)


def _program_host(store, plan: FusedPlan):
    """The store a program is keyed by: the snapshot when every stage
    reads the snapshot's own data (an ACL view's readable predicates,
    `engine/batch.py:_cache_host`), so a view and its snapshot share
    programs and neither drops the other's; else the store itself."""
    from dgraph_tpu_torch.engine.batch import _cache_host
    hosts = {_cache_host(store, st.attr, st.reverse) for st in plan.stages}
    return hosts.pop() if len(hosts) == 1 else store


def _program_for(plan: FusedPlan, caps: tuple, layout: tuple, rels: tuple,
                 ex) -> _Program:
    key = (_store_key(_program_host(ex.store, plan)), plan.sig, caps,
           layout, ex.device)
    with _lock:
        prog = _programs.get(key)
        if prog is not None and any(a is not b
                                    for a, b in zip(prog.rels, rels)):
            # a tensor it reads was evicted and placed again since: a
            # program only ever runs on the tensors the store holds
            _drop(key)
            prog = None
        hit = prog is not None
        if hit:
            _programs.move_to_end(key)
            _stats["hits"] += 1
        else:
            _stats["misses"] += 1
            prog = _programs[key] = _Program(
                _build_program(tuple(plan.stages), caps, layout), rels,
                ex.device, tuple(plan.stages), caps, layout)
            _evict()
    METRICS.inc("fused_program_hits_total" if hit
                else "fused_program_misses_total")
    return prog


def status() -> dict:
    """Counters since the last `reset()`: routes taken per block
    (fused, staged, fallback), fallbacks (failed programs), program
    hits and misses, captures and their milliseconds, the programs held
    and evicted, the device memory their graphs reserve, and the query
    shapes pinned to the staged route."""
    with _lock:
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in _stats.items()}
        out["disabled"] = sorted(_disabled)
        out["programs"] = len(_programs)
    out["enabled"] = enabled()
    return out


def captured() -> list:
    """The programs that hold a captured graph, oldest first."""
    with _lock:
        return [p for p in _programs.values() if p.graph is not None]


def reset(counters: bool = True) -> None:
    """Forget programs (and their graphs) and caps; with `counters`
    (the default) also the counters and the sticky fallbacks."""
    global _stats
    with _lock:
        for prog in _programs.values():
            prog.held = False
        _programs.clear()
        _caps_memo.clear()
        if counters:
            _disabled.clear()
            _stats = _fresh_stats()
        else:
            _stats["program_bytes"] = 0


# -- runtime --------------------------------------------------------------------

def _routed(store) -> bool:
    """Does `store`, or a view it wraps (an ACL view over a routed one),
    route foreign tablets over the wire (`cluster/routed.RoutedView`)?"""
    while store is not None:
        if getattr(store, "remote_expand", None) is not None:
            return True
        store = getattr(store, "_base", None)
    return False


def try_fused(ex, sg):
    """The engine hook (`Executor._run_block`): serve one root block as
    one program, or return None for the staged route. Counts the route
    either way. An allocation failure the evict-and-retry did not absorb
    degrades the shape to the staged route on the same device. On the
    card any other failure of a program (capture, launch) raises. On the
    CPU it is logged, its shape goes to the staged route for good, and
    the staged route serves. A routed view (a clustered Alpha's,
    `cluster/routed.py`) runs the staged route, as in the reference:
    reading its plan's relations would fault foreign tablets over the
    wire inside the warm-up and the capture."""
    if not enabled():
        return None
    if _routed(ex.store):
        _route("staged")
        return None
    from dgraph_tpu_torch.engine import shape_of
    shape = shape_of([sg])
    with _lock:
        disabled = shape in _disabled
    if disabled or memgov.GOVERNOR.is_degraded("fused.program", shape):
        _route("fallback")
        return None
    try:
        plan = plan_block(ex.store, sg)
        if plan is not None:
            with tracing.span("engine.fused", shape=shape,
                              stages=len(plan.stages)) as sp:
                node = memgov.oom_retry(
                    "fused.program", shape,
                    lambda: _run_plan(ex, sg, plan, sp), degrade=True)
            if node is not None:
                _route("fused")
                return node
    except (dl.DeadlineExceeded, dl.Cancelled):
        raise    # the request's budget died: not the program's failure
    except memgov.OomDegraded:
        # counted and logged by the governor: the staged route serves
        # this shape on the same device until the degraded set is reset
        with _lock:
            _stats["fallbacks"] += 1
        METRICS.inc("fused_fallback_total")
        _route("fallback")
        return None
    except Exception:  # noqa: BLE001 — the staged route serves instead
        if ex.device.type == "cuda":
            raise
        with _lock:
            _disabled.add(shape)
            _stats["fallbacks"] += 1
        METRICS.inc("fused_fallback_total")
        _log.warning("fused program for shape %s failed; the staged route "
                     "serves this shape from now on", shape, exc_info=True)
        _route("fallback")
        return None
    _route("staged")
    return None


def _run_plan(ex, sg, plan: FusedPlan, sp=None):
    """The host shell around one program call: allowed sets and the
    root, caps (overflow contract), the call, the copy back, unpacking.
    Returns the root LevelNode, or None when the data needs the staged
    route (an empty relation, a complement-shaped filter). The call's
    gathered edges go on the span `sp` (`edges`), as the reference's."""
    store = ex.store
    rels, devs, alloweds, pages = [], [], [], []
    for st, ssg in zip(plan.stages, plan.stage_sgs):
        if st.kind in ("knn", "featprop"):
            t = store.vec_tablet(st.attr)
            if t is None or not t.rows:
                return None   # the staged route serves the empty tablet
            q = EMPTY
            if st.kind == "knn":
                try:
                    resolved = vec.resolve_query(store, sg.func)
                except ValueError:
                    return None   # malformed: the staged route raises it
                if resolved is None:
                    return None   # unknown uid, or a uid without a row
                q = resolved[2].view(np.int32)
            rels.append(t)
            devs.append(store.vec_device(st.attr, ex.device))
            alloweds.append(q)
            pages.append((0, NO_LIMIT))
            continue
        rel = store.rel(st.attr, st.reverse)
        if rel.nnz == 0:
            return None           # the staged route short-circuits empties
        allowed = EMPTY
        if st.has_filter:
            allowed = ex.filter_set(ssg.filters)
            if allowed is None:
                return None       # complement-shaped at run time
        rels.append(rel)
        devs.append(store.device_rel(st.attr, st.reverse, ex.device))
        alloweds.append(allowed)
        first = ssg.first if (st.kind == "hop" and ssg.first) else NO_LIMIT
        offset = ssg.offset if st.kind == "hop" else 0
        pages.append((offset, first))

    if plan.knn:
        # the seed set is computed inside the program; the root binds
        # from its knn output after the call
        display = nodes = EMPTY
    else:
        display = ex.root_display(sg)
        nodes = np.unique(display).astype(np.int32)
    with _lock:
        caps = _caps_memo.get(plan.sig)
    if caps is None:
        caps = _estimate_caps(plan, rels, nodes)
    caps = list(caps)
    if plan.knn:
        # memoized caps may predate the tablet: the seed buffer must hold
        # this snapshot's min(k, rows)
        caps[0] = (max(caps[0][0],
                       _bucket(max(min(plan.stages[0].k, rels[0].rows), 1))),)
    ri = 1 if plan.knn else 0
    if plan.recurse:
        # memoized caps may come from a smaller root set: the recurse
        # stage's frontier buffer must hold this query's roots (for a knn
        # seed, the seed stage's cap)
        floor = max(_bucket(max(len(nodes), 1)),
                    caps[0][0] if plan.knn else 0)
        if caps[ri][1] < floor:
            caps[ri] = (caps[ri][0], floor)
    caps = tuple(caps)
    # the first stage's input count: a knn plan's seeds
    n_roots = (min(plan.stages[0].k, rels[0].rows) if plan.knn
               else len(nodes))

    t_exec = time.perf_counter()
    for _attempt in range(_MAX_ATTEMPTS):
        # budget gate before the device is committed to a program call
        dl.checkpoint("kernel")
        f_cap = (caps[0][1] if plan.recurse and not plan.knn
                 else _bucket(max(len(nodes), 1)))
        flat, layout = _pack(nodes, f_cap, alloweds, pages)
        prog = _program_for(plan, caps, layout, tuple(devs), ex)
        with prog.lock:
            sizes, outs = prog.run(flat, lambda s, c=caps: not _grow_caps(
                plan, c, _split_sizes(plan, s), nodes)[1])
            split = _split_sizes(plan, sizes)
            new_caps, overflowed = _grow_caps(plan, caps, split, nodes)
            if not overflowed:
                host = _fetch(plan, outs, split, n_roots)
                prog.last = (split, n_roots)
        if not overflowed:
            break
        caps = new_caps
    else:
        raise RuntimeError("fused caps failed to converge")
    with _lock:
        _caps_memo[plan.sig] = caps
    t_end = time.perf_counter()
    costprofile.add_shape("fused")
    costprofile.add_kernel("fused", execute_us=(t_end - t_exec) * 1e6)
    costprofile.note_launch(t_exec, t_end)
    total_edges = 0
    for st, sz, rel in zip(plan.stages, split, rels):
        n = rel.rows if st.kind in ("knn", "featprop") else 0
        if st.kind in ("hop", "recurse"):   # one expansion per stage
            edges = int(sz[2]) if st.kind == "hop" else int(sz[2].sum())
            ex.routes.add("program", edges)
            total_edges += edges
            n = edges
        if st.kind != "count":
            # modeled per-tablet µs, the staged expansion's ~16 edges/µs
            costprofile.add_tablet_cost(st.attr, n // 16 + 1)
    if sp is not None:
        sp.attrs["edges"] = total_edges
    if plan.knn:
        vec.count_fused()
        # the root set is the program's own seed output: sorted, the
        # first min(k, rows) entries real
        display = nodes = host[0][0]
    if plan.featprop:
        count_route("fused", int(host[-1][1].sum()), rels[-1].dim,
                    (time.perf_counter() - t_exec) * 1e6)
    return _unpack(ex, sg, plan, host, display, nodes)


def _split_sizes(plan: FusedPlan, sizes: np.ndarray) -> list:
    """The packed sizes per stage: a hop's (n_kept, n_unique, total), a
    recurse stage's [3, depth] rows (kept, unique, total per hop), None
    for the capless kinds (count, knn, featprop)."""
    out, off = [], 0
    for st in plan.stages:
        if st.kind == "hop":
            out.append(sizes[off:off + 3])
            off += 3
        elif st.kind == "recurse":
            out.append(sizes[off:off + 3 * st.depth].reshape(3, st.depth))
            off += 3 * st.depth
        else:
            out.append(None)
    return out


def _estimate_caps(plan: FusedPlan, rels, nodes) -> tuple:
    """First-call cap guesses: root-fed stages are exact (their frontier
    is known); deeper stages bound by parent estimate × average degree
    with headroom. The overflow contract corrects any miss."""
    caps = []
    est_nodes = {-1: max(len(nodes), 1)}
    for i, (st, rel) in enumerate(zip(plan.stages, rels)):
        if st.kind in ("count", "featprop"):
            # count reduces over the parent's frontier, featprop over the
            # recurse stage's own matrices
            caps.append(())
            continue
        if st.kind == "knn":
            # exact: the seed stage emits min(k, rows) ranks (rel is the
            # VecTablet here) and cannot overflow
            seeds = max(min(st.k, rel.rows), 1)
            caps.append((_bucket(seeds),))
            est_nodes[i] = seeds
            continue
        n_rows = max(int(len(rel.indptr)) - 1, 1)
        if st.parent == -1 and len(nodes):
            est = int(rel.degree(nodes).sum())
        else:
            avg = rel.nnz / n_rows
            est = int(est_nodes[st.parent] * (avg + 1.0) * 2.0)
        ecap = _bucket(max(est, 1))
        if st.kind == "recurse":
            out_floor = max(len(nodes), 1)
            if st.parent >= 0:   # knn-fed: the buffer must hold the seeds
                out_floor = max(out_floor, caps[st.parent][0])
            caps.append((ecap, _bucket(out_floor)))
        else:
            caps.append((ecap,))
        est_nodes[i] = max(1, min(est, n_rows))
    return tuple(caps)


def _grow_caps(plan: FusedPlan, caps: tuple, split: list, nodes):
    """Check the program's true sizes against the static caps and regrow
    geometrically where they overflowed (a truncated parent makes deeper
    totals lower bounds; the loop converges because caps only grow)."""
    new_caps = list(caps)
    overflowed = False
    for i, (st, sz) in enumerate(zip(plan.stages, split)):
        if st.kind == "hop":
            total = int(sz[2])
            if total > caps[i][0]:
                new_caps[i] = (_bucket(max(total, 2 * caps[i][0])),)
                overflowed = True
        elif st.kind == "recurse":
            need_edge, need_out = int(sz[2].max()), int(sz[1].max())
            ecap, ocap = caps[i]
            if need_edge > ecap or need_out > ocap:
                new_caps[i] = (
                    _bucket(max(need_edge, ecap)),
                    _bucket(max(need_out, ocap, len(nodes), 1)))
                overflowed = True
    return tuple(new_caps), overflowed


def _fetch(plan: FusedPlan, outs, split: list, n_roots: int) -> list:
    """The outputs the host needs, copied to numpy and cut to their true
    lengths, in the reference program's per-stage layout. `n_roots` is
    the first stage's input count (a knn plan's seeds)."""
    host = []
    for st, out, sz in zip(plan.stages, outs, split):
        if st.kind == "knn":
            host.append((out[0][:n_roots].cpu().numpy(),))
            continue
        if st.kind == "featprop":
            # a hop's segments are its input frontier's positions: at most
            # the roots (hop 0) or the previous hop's unique count
            uniq_h = split[st.parent][1]
            m = max([n_roots] + [int(u) for u in uniq_h[:-1]] + [1])
            feats, cnt, ecnt = out
            host.append((feats[:, :m].cpu().numpy(), cnt.cpu().numpy(),
                         ecnt[:, :m].cpu().numpy()))
            continue
        if st.kind == "hop":
            c_nbrs, c_seg, c_pos, _k, nxt, _u, _t = out
            n_kept, n_unique, total = (int(v) for v in sz)
            cols = torch.stack([c_nbrs[:n_kept], c_seg[:n_kept],
                                c_pos[:n_kept]]).cpu().numpy()
            host.append((cols[0], cols[1], cols[2], n_kept,
                         nxt[:n_unique].cpu().numpy(), n_unique, total))
        elif st.kind == "recurse":
            nbrs_h, seg_h, _k, fr_h, _t, _u = out
            kept_h, uniq_h, tot_h = sz
            m = int(kept_h.max())
            host.append((nbrs_h[:, :m].cpu().numpy(),
                         seg_h[:, :m].cpu().numpy(), kept_h,
                         fr_h.cpu().numpy(), tot_h, uniq_h))
        else:
            # a count below the root or below a knn seed stage
            root_fed = st.parent < 0 or (plan.knn and st.parent == 0)
            n_parent = n_roots if root_fed else int(split[st.parent][1])
            host.append((out[0][:n_parent].cpu().numpy(),))
    return host


def _unpack(ex, sg, plan: FusedPlan, host, display, nodes):
    """Rebuild the LevelNode tree from the program's outputs, binding
    variables in the order `Executor._descend` would (child order within
    each level, whole subtrees before later siblings)."""
    root = LevelNode(sg=sg, nodes=nodes, display=display.astype(np.int32))
    if sg.var_name:
        ex.uid_vars[sg.var_name] = nodes
    if plan.recurse:
        _unpack_recurse(ex, root, plan, host)
    else:
        _attach(ex, plan, host, 0 if plan.knn else -1, root)
    return root


def _attach(ex, plan: FusedPlan, host, parent_idx: int, parent_node):
    hop_iter = iter(plan.children_of.get(parent_idx, ()))
    counts = plan.counts_of.get(parent_idx, {})
    for c in parent_node.sg.children:
        if expands(ex.store.schema, c):
            si = next(hop_iter)
            c_nbrs, c_seg, c_pos, _n, nxt, _u, _t = host[si]
            node = LevelNode(
                sg=c, nodes=nxt.astype(np.int32),
                matrix_seg=c_seg.astype(np.int32),
                matrix_child=c_nbrs.astype(np.int32),
                matrix_pos=c_pos.astype(np.int64))
            if c.var_name:
                ex.uid_vars[c.var_name] = node.nodes
            parent_node.children.append(node)
            _attach(ex, plan, host, si, node)
        else:
            parent_node.leaf_sgs.append(c)
            si = counts.get(id(c))
            if si is not None:
                # the program's degrees, aligned to the parent's nodes:
                # the values the staged _record_leaf_vars takes from
                # rel.degree
                (deg,) = host[si]
                ex.val_vars[c.var_name] = {
                    int(r): int(d) for r, d in zip(parent_node.nodes, deg)}
            else:
                ex._record_leaf_vars(c, parent_node)


def _unpack_recurse(ex, root, plan: FusedPlan, host) -> None:
    """RecurseData from the recurse stage's per-hop matrices: the host
    loop's visit-once first-visit-tree semantics, hop order kept."""
    ri = 1 if plan.knn else 0
    nbrs_h, seg_h, kept_h, fr_h, _tot, _uniq = host[ri]
    data = split_children(ex, root.sg, RecurseData(loop=False))
    parts_p, parts_c = [], []
    for h in range(len(kept_h)):
        k = int(kept_h[h])
        if not k:
            continue
        parts_p.append(fr_h[h][seg_h[h][:k]].astype(np.int32))
        parts_c.append(nbrs_h[h][:k].astype(np.int32))
    if parts_p:
        data.edges[0] = (np.concatenate(parts_p), np.concatenate(parts_c))
        data.all_nodes = np.union1d(
            root.nodes, np.concatenate(parts_c)).astype(np.int32)
    else:
        data.all_nodes = root.nodes.copy()
    if plan.featprop:
        # per hop, every input-frontier position with a kept edge carries
        # its [d] combine, keyed by rank: the staged post-pass's entries
        feats, _cnt, ecnt = host[ri + 1]
        fv: dict = {}
        for h in range(len(kept_h)):
            if not int(kept_h[h]):
                continue
            for p in np.nonzero(ecnt[h] > 0)[0].tolist():
                fv[int(fr_h[h][p])] = feats[h][p]
        data.feat_vals = fv
        data.feat_key = feat_key(root.sg.msgpass)
    _bind_recurse_vars(ex, root, data, root.sg)
    root.recurse_data = data
