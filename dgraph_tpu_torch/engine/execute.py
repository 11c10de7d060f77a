"""SubGraph execution: one root block at a time, level by level.

Port of `dgraph_tpu/engine/execute.py`. On a clustered Alpha's routed
view a small-frontier hop over a foreign tablet runs on its owner
(`expand`, route "remote"). With a mesh (`parallel/mesh.py`, of one
process or across several) a large frontier expands on
every shard at once: `parallel/dhop.matrix_hop` over the row-sharded CSR
(`Store.sharded_rel`), or, past `ring_threshold` rows, the ring of
`ring_matrix_hop`; a frontier below `device_threshold` takes the mesh
when the cost priors' route EMAs say it beats the host walk
(`_mesh_promoted`; the lead's EMAs while the mesh spans processes). The host stitches the shards' edge lists back into
global row order (`_stitch_edge_parts`). The fused level runs as
`matrix_level`, single-key orderings as `parallel/dsort.py`'s
`mesh_topk` (root) and `mesh_row_sort` (child level), and every
expansion counts `mesh_route_total{route=}`; both mesh hops run under
the allocation-failure lifecycle at sites `mesh.matrix_hop` and
`mesh.ring_matrix_hop`, and raise after one evict-and-retry (which
every rank takes together while the mesh spans processes). Over a mesh
that spans processes the stitches read the shards' outputs through
`mesh.host_np` and `mesh.gather_columns` only, which gather the other
processes' parts (the columns a stitch reads in one gather), and each
mesh route (an expansion, a fused level, an order-by) runs as one
`mesh.lockstep` scope: one closing round for all its collectives, and a failure on one
rank known to every rank.
An eligible root block runs first as one whole-block program
(`engine/fused.py`, which ignores `device_threshold`, as the
reference's does); the rest is the staged route below. Each level's
expansion is ONE batched CSR gather over the whole frontier: frontiers
of at least `device_threshold` rows expand on the device through torch
ops (`ops/hop.py:gather_edges`, or the fused `ops/level.py:expand_level`
where no ordering, facet filter or `after` cursor needs per-edge host
logic); smaller ones take the host numpy walk `csr_rows`. Every route
produces the same (neighbors, seg, edge_pos) triple. The device gather
runs under the memory governor's allocation-failure lifecycle at site
`hop.gather_edges` (utils/memgov.py): an allocation failure evicts to
the low watermark and retries once on the card; a second one raises, as
any other device failure does: there is no fallback to the host walk. A
`similar_to` root takes the routed top-k of `store/vec.py`, and blocks
with `@msgpass` bind their aggregates after the descent
(`engine/feat.py:annotate_tree`).

A level's result is a `LevelNode`:
  nodes        sorted unique ranks at this level (the next frontier)
  matrix_seg   edge → position in parent.nodes
  matrix_child edge → child rank (row-ordered: order/pagination applied)
  matrix_pos   edge → forward/reverse CSR position (facets)

Each expansion adds to the executor's `RouteCounts` (expansions, edges
and the device ops' least bytes per route) and to
`edges_traversed_total{path=}`, and to the request's cost record
(`utils/costprofile.py`: edges, modeled bytes gathered, the largest
tablet touched, per-tablet cost) and the route EMAs of the cost priors;
`chip_smoke.py` reads them to show which route served. Each root block
and each level is a deadline checkpoint and a span (`engine.block`,
`engine.level`, utils/tracing.py). The
device work sits in `torch.profiler` ranges (`hop.gather_edges`,
`level.expand_level`, `engine.to_device`, `engine.to_host`) so a profile
attributes device time per op.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from dgraph_tpu_torch.engine.funcs import (EMPTY, eval_func,
                                           eval_func_universe)
from dgraph_tpu_torch.engine.groupby import (process_groupby,
                                             process_groupby_rows)
from dgraph_tpu_torch.engine.feat import annotate_tree, needs_msgpass
from dgraph_tpu_torch.engine.ir import FilterNode, FuncNode, Order, SubGraph
from dgraph_tpu_torch.engine.mathexpr import eval_math
from dgraph_tpu_torch.engine.varorder import _filter_uses
from dgraph_tpu_torch.ops.hop import gather_edges
from dgraph_tpu_torch.ops.level import NO_LIMIT, expand_level
from dgraph_tpu_torch.ops.uidalgebra import SENTINEL32, pad_to
from dgraph_tpu_torch.parallel.mesh import (gather_columns, host_np,
                                            lockstep, promoted)
from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.store.types import Kind
from dgraph_tpu_torch.store.vec import similar_ranks
from dgraph_tpu_torch.utils import costprior, costprofile, memgov, tracing
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dgraph_tpu_torch.utils.metrics import METRICS

EMPTY64 = np.zeros(0, np.int64)

ROUTES = ("device", "fused", "program", "mesh", "mesh_level", "mesh_chain",
          "numpy", "remote", "empty")


@dataclass
class LevelNode:
    sg: SubGraph
    nodes: np.ndarray                      # sorted unique int32 ranks
    matrix_seg: np.ndarray = field(default_factory=lambda: EMPTY)
    matrix_child: np.ndarray = field(default_factory=lambda: EMPTY)
    matrix_pos: np.ndarray = field(default_factory=lambda: EMPTY64)
    display: np.ndarray | None = None      # root blocks: ordered rank list
    children: list["LevelNode"] = field(default_factory=list)
    leaf_sgs: list[SubGraph] = field(default_factory=list)
    recurse_data: object | None = None     # engine.recurse.RecurseData
    path_data: object | None = None        # engine.shortest.PathData
    groups: object | None = None           # engine.groupby.GroupResult
    # @msgpass binding (engine/feat.py): rank → f32[d] aggregate; None
    # means the level carries no binding (key "" likewise)
    feat_vals: dict | None = None
    feat_key: str = ""


_EDGE_PATH = {"program": "fused", "mesh_level": "fused",
              "mesh_chain": "chain"}


@dataclass
class RouteCounts:
    """Expansions and edges per execution route: `device` (gather_edges
    on the device), `fused` (expand_level on the device), `program` (a
    hop or recurse stage of a whole-block program, `engine/fused.py`),
    `mesh` (matrix_hop or ring_matrix_hop on a mesh), `mesh_level`
    (matrix_level), `mesh_chain` (a hop of the mesh `@recurse`,
    `engine/recurse.py`), `numpy` (the host walk), `remote` (a hop its
    owner served over the worker transport) and `empty` (nothing to
    expand).
    `least_bytes` sums, per device route, the bytes its op must move:
    each input read once (the frontier, its rows' indptr pairs, the
    edges' indices, the allowed set) and each output written once (the
    padded output columns)."""

    expansions: dict = field(default_factory=lambda: dict.fromkeys(ROUTES, 0))
    edges: dict = field(default_factory=lambda: dict.fromkeys(ROUTES, 0))
    least_bytes: dict = field(default_factory=lambda: dict.fromkeys(ROUTES, 0))

    def add(self, route: str, n_edges: int, least_bytes: int = 0) -> None:
        self.expansions[route] += 1
        self.edges[route] += int(n_edges)
        self.least_bytes[route] += int(least_bytes)
        if n_edges:
            # the north-star counter under the reference's path labels
            # (a whole-block program's stage is its "fused" path)
            METRICS.inc("edges_traversed_total", float(n_edges),
                        path=_EDGE_PATH.get(route, route))
            costprofile.add("edges_traversed", int(n_edges))
            # gather-traffic model: neighbor + seg + position words
            costprofile.add("bytes_gathered", 16 * int(n_edges))

    def on_device(self) -> int:
        """Expansions the device (or the mesh) served."""
        return sum(self.expansions[r] for r in MESH_ROUTES + (
            "device", "fused", "program"))


MESH_ROUTES = ("mesh", "mesh_level", "mesh_chain")


def _bucket(n: int, lo: int = 64) -> int:
    b = lo
    # graftlint: allow(hot-loop-checkpoint): O(log n) shift arithmetic
    while b < n:
        b <<= 1
    return b


def csr_rows(rel, frontier: np.ndarray):
    """Host CSR row gather for a frontier → (neighbors, seg, edge_pos)."""
    starts = rel.indptr[frontier]
    deg = rel.indptr[frontier + 1] - starts
    total = int(deg.sum())
    if total == 0:
        return EMPTY, EMPTY, EMPTY64
    seg = np.repeat(np.arange(len(frontier), dtype=np.int32), deg)
    base = np.repeat(np.cumsum(deg) - deg, deg)
    pos = np.repeat(starts.astype(np.int64), deg) + \
        (np.arange(total, dtype=np.int64) - base)
    return rel.indices[pos], seg, pos


def _to_host(*cols: torch.Tensor) -> list[np.ndarray]:
    """Equal-length int32 device columns → host arrays, one copy."""
    if not cols[0].shape[0]:
        return [EMPTY] * len(cols)
    with record_function("engine.to_host"):
        return list(torch.stack(cols).cpu().numpy())


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A sorted rank set, sentinel-padded to its bucket, on `device`."""
    with record_function("engine.to_device"):
        return pad_to(a, _bucket(max(len(a), 1)), device)


def _host_pad(a: np.ndarray, size: int) -> np.ndarray:
    """A sorted rank set sentinel-padded to `size` on the host: a mesh
    program's upload (a host input is never a reshard)."""
    out = np.full(size, SENTINEL32, np.int32)
    out[:len(a)] = a
    return out


def check_mesh(mesh, device: torch.device):
    """`mesh`, once its devices are of `device`'s type (a CPU engine
    over card shards, or the reverse, raises)."""
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a mesh of {mesh.device_type} devices cannot "
                         f"serve an engine on {device}")
    return mesh


def _gather_bytes(n_front: int, f_cap: int, total: int) -> int:
    """Least bytes of one frontier gather: the padded frontier, the
    indptr pair of each real row and each edge's index, read once."""
    return 4 * f_cap + 8 * n_front + 4 * total


class Executor:
    """Executes SubGraph trees against a Store snapshot.

    `device_threshold`: frontiers at least this large expand on `device`
    (on `mesh` when one is given); smaller ones take the host walk. 0
    sends every non-empty frontier to the device; 10**9 keeps all work
    on the host. A mesh's devices must be of `device`'s type."""

    def __init__(self, store: Store, device=DEFAULT_DEVICE,
                 device_threshold: int = 512,
                 routes: RouteCounts | None = None, mesh=None):
        self.store = store
        self.device = resolve_device(device)
        self.device_threshold = device_threshold
        self.routes = routes if routes is not None else RouteCounts()
        self.mesh = check_mesh(mesh, self.device)
        # variable environments (reference: query var propagation)
        self.uid_vars: dict[str, np.ndarray] = {}
        self.val_vars: dict[str, dict[int, object]] = {}

    # -- frontier expansion (the hot op) ------------------------------------
    def expand(self, pred: str, reverse: bool, frontier: np.ndarray,
               allow_remote: bool = True):
        """Whole-frontier CSR expansion → (neighbors, seg, edge_pos) host
        arrays. `edge_pos` indexes the CSR of the expansion direction;
        facet consumers map reverse positions through facet_positions().

        On a routed view (a clustered Alpha's, `cluster/routed.py`), a
        small-frontier hop over a foreign tablet may run on its OWNER
        through ServeTask instead of faulting the whole tablet in
        (reference: ProcessTaskOverNetwork), counted as route "remote";
        remote results carry no edge positions, so callers needing
        facets pass allow_remote=False."""
        t0 = time.perf_counter()
        if allow_remote and len(frontier):
            remote = getattr(self.store, "remote_expand", None)
            out = remote(pred, reverse, frontier) if remote is not None \
                else None
            if out is not None:
                self.routes.add("remote", len(out[0]))
                self._count_mesh_route("remote")
                if len(out[0]):
                    costprior.PRIORS.learn_route(
                        "remote", (time.perf_counter() - t0) * 1e6
                        / len(out[0]) * 1000.0)
                    costprofile.add_tablet_cost(pred, len(out[0]) // 16 + 1)
                return out
        rel = self.store.rel(pred, reverse)
        # cost-model regressor: the largest tablet this request touched
        costprofile.note_max("tablet_rows", int(len(rel.indptr)) - 1)
        if len(frontier) == 0 or rel.nnz == 0:
            self.routes.add("empty", 0)
            self._count_mesh_route("empty")
            return EMPTY, EMPTY, EMPTY64
        if self.mesh is not None and (
                len(frontier) >= self.device_threshold
                or self._mesh_promoted(len(frontier))):
            with lockstep(self.mesh, "mesh.expand"):
                out = self._expand_mesh(pred, reverse, frontier)
            path = "mesh"
        elif len(frontier) >= self.device_threshold:
            out, path = self._expand_device(pred, reverse, frontier), "device"
        else:
            out, path = csr_rows(rel, frontier), "numpy"
            self.routes.add("numpy", len(out[0]))
        self._count_mesh_route(path)
        if len(out[0]):
            # learned route costs: µs per 1k edges EMA per path
            costprior.PRIORS.learn_route(
                path, (time.perf_counter() - t0) * 1e6
                / len(out[0]) * 1000.0)
            # placement signal: modeled µs charged to this tablet
            costprofile.add_tablet_cost(pred, len(out[0]) // 16 + 1)
        return out

    def _expand_device(self, pred: str, reverse: bool, frontier: np.ndarray):
        total = int(self.store.rel(pred, reverse).degree(frontier).sum())
        ecap = _bucket(max(total, 1))

        def _launch():
            indptr, indices = self.store.device_rel(pred, reverse,
                                                    self.device)
            fr = _to_device(frontier, self.device)
            t0 = time.perf_counter()
            with record_function("hop.gather_edges"):
                nbrs, seg, pos, _valid, _total = gather_edges(
                    indptr, indices, fr, ecap)
            costprofile.note_launch(t0, time.perf_counter())
            # the valid slots are exactly the first `total` (known on the
            # host from the same CSR): one device-to-host copy of the
            # three columns
            return fr.shape[0], _to_host(nbrs[:total], seg[:total],
                                         pos[:total])

        f_cap, (nbrs, seg, pos) = memgov.oom_retry(
            "hop.gather_edges", (pred, reverse), _launch)
        # outputs: neighbors, seg, edge_pos int32 and valid bool per slot
        self.routes.add("device", total, _gather_bytes(
            len(frontier), f_cap, total) + 13 * ecap)
        return nbrs, seg, pos.astype(np.int64)

    # -- the mesh routes ------------------------------------------------------
    def _count_mesh_route(self, path: str) -> None:
        """Route-selector accounting while a mesh is configured: which
        route served (the promotion A/B signal)."""
        if self.mesh is not None:
            METRICS.inc("mesh_route_total", route=path)

    # learned-promotion floor: below this many frontier rows, per-launch
    # dispatch overhead dominates any measured per-edge win, so the host
    # walk keeps them whatever the route EMAs say
    mesh_floor = 64

    def _mesh_promoted(self, n: int) -> bool:
        """Cost-prior route promotion: a frontier below device_threshold
        still takes the mesh when the measured per-edge cost EMAs
        (utils/costprior.py, learned from every expansion) say the mesh
        beats the host walk. Without data, or with priors off, the
        threshold alone routes. While the mesh spans processes the
        lead's EMAs decide, once per request (parallel/mesh.py
        `promoted`): a rank's own timings must not choose a route the
        other ranks do not take."""
        if n < self.mesh_floor:
            return False
        return promoted(self.mesh, "mesh", "numpy")

    def _note_mesh_shards(self, counts) -> None:
        """Shard-keyed accounting for one mesh expansion: the `mesh`
        shape component and `mesh_shards` feature of the request's cost
        record, and modeled per-shard µs (~16 edges per µs, the scale
        tablets are charged at) into the shard cost sums
        (`/debug/scheduler`)."""
        counts = np.asarray(counts)
        costprofile.add_shape("mesh")
        costprofile.note_max("mesh_shards", int(len(counts)))
        for d, c in enumerate(counts.tolist()):
            if int(c):
                costprofile.add_shard_cost(d, int(c) // 16 + 1)

    def _shard_edge_cap(self, n_shards: int, rows_per_shard: int,
                        frontier: np.ndarray, deg: np.ndarray) -> int:
        """Per-shard edge-cap bucket: rows partition over shards, so each
        shard needs only ITS slab's degree sum."""
        shard_of = np.minimum(frontier // rows_per_shard, n_shards - 1)
        per_shard = np.bincount(shard_of, weights=deg, minlength=n_shards)
        return _bucket(max(int(per_shard.max()), 1))

    @staticmethod
    def _stitch_edge_parts(parts):
        """Stitch per-shard edge slices into one global edge matrix: each
        frontier row's edges come from exactly one slice, so a stable
        sort by seg recovers global CSR row order. `parts` yields (nbrs,
        seg, local_pos, pos_lo): pos offsets into the absolute facet
        position space."""
        parts_n, parts_s, parts_p = [], [], []
        for nbrs, seg, pos, pos_lo in parts:
            if not len(nbrs):
                continue
            parts_n.append(nbrs)
            parts_s.append(seg)
            parts_p.append(pos.astype(np.int64) + int(pos_lo))
        if not parts_n:
            return EMPTY, EMPTY, EMPTY64
        nbrs = np.concatenate(parts_n)
        seg = np.concatenate(parts_s)
        pos = np.concatenate(parts_p)
        order = np.argsort(seg, kind="stable")
        return nbrs[order], seg[order], pos[order]

    @classmethod
    def _reassemble_shards(cls, srel, nbrs_s, seg_s, pos_s, counts):
        """The shards' first counts[d] slots of (nbrs, seg, pos), one
        device-to-host copy per shard (other processes' shards arrive by
        one gather of the three columns' first max(counts) slots),
        stitched."""
        counts = host_np(counts).tolist()
        top = max(max(int(c) for c in counts), 1)
        with record_function("engine.to_host"):
            cols = gather_columns([x.prefix(top)
                                   for x in (nbrs_s, seg_s, pos_s)])
            host = [_to_host(*(col[d][:int(c)] for col in cols))
                    for d, c in enumerate(counts)]
        return cls._stitch_edge_parts(
            (h[0], h[1], h[2], srel.pos_lo[d]) for d, h in enumerate(host))

    # frontiers above this replicate poorly: shard them and rotate the
    # chunks around the ring instead. Tests lower it to force the ring.
    ring_threshold = 1 << 17

    def _expand_mesh(self, pred: str, reverse: bool, frontier: np.ndarray):
        """Expansion over the mesh: every shard expands the row slab it
        owns, the outputs stay sharded, the host stitches the edge
        matrix (the reference's scatter/gather over groups). Frontiers
        past ring_threshold take the sharded ring."""
        from dgraph_tpu_torch.parallel.dhop import matrix_hop

        if len(frontier) > self.ring_threshold:
            return self._expand_mesh_ring(pred, reverse, frontier)
        D = self.mesh.size
        srel = self.store.sharded_rel(pred, reverse, self.mesh)
        f_cap = _bucket(len(frontier))
        fr = _host_pad(frontier, f_cap)
        deg = self.store.rel(pred, reverse).degree(frontier)
        edge_cap = self._shard_edge_cap(D, srel.rows_per_shard, frontier,
                                        deg)

        def _launch():
            placed = self.store.sharded_rel(pred, reverse, self.mesh)
            t0 = time.perf_counter()
            with record_function("mesh.matrix_hop"):
                nbrs_s, seg_s, pos_s, totals, max_shard = matrix_hop(
                    self.mesh, placed, fr, edge_cap)
                totals = host_np(totals)
            costprofile.note_launch(t0, time.perf_counter())
            return placed, nbrs_s, seg_s, pos_s, totals, int(max_shard)

        placed, nbrs_s, seg_s, pos_s, totals, max_shard = memgov.oom_retry(
            "mesh.matrix_hop", (pred, reverse), _launch, mesh=self.mesh)
        if max_shard > edge_cap:
            raise AssertionError(f"mesh.matrix_hop: {max_shard} edges on "
                                 f"a shard past its cap {edge_cap}")
        self._note_mesh_shards(totals)
        out = self._reassemble_shards(placed, nbrs_s, seg_s, pos_s, totals)
        total = int(deg.sum())
        # each shard reads the replicated frontier and writes its
        # (nbrs, seg, pos, valid) slots
        self.routes.add("mesh", total, D * 4 * f_cap + 8 * len(frontier)
                        + 4 * total + D * 13 * edge_cap)
        return out

    def _expand_mesh_ring(self, pred: str, reverse: bool,
                          frontier: np.ndarray):
        """Sharded-frontier expansion: the frontier's chunks rotate
        around the ring (ppermute) while every shard expands the
        resident chunk against its row slab."""
        from dgraph_tpu_torch.parallel.dhop import ring_matrix_hop
        from dgraph_tpu_torch.parallel.pshard import shard_frontier

        srel = self.store.sharded_rel(pred, reverse, self.mesh)
        d = srel.n_shards
        per = -(-len(frontier) // d)
        f_cap = _bucket(max(per, 1))
        chunks = shard_frontier(frontier, d, f_cap)
        # per (origin chunk × shard) edge cap: a chunk meets every slab
        deg = self.store.rel(pred, reverse).degree(frontier)
        shard_of = np.minimum(frontier // srel.rows_per_shard, d - 1)
        chunk_of = np.minimum(np.arange(len(frontier)) // per, d - 1)
        per_pair = np.zeros((d, d))
        np.add.at(per_pair, (chunk_of, shard_of), deg)
        edge_cap = _bucket(max(int(per_pair.max()), 1))

        def _launch():
            placed = self.store.sharded_rel(pred, reverse, self.mesh)
            t0 = time.perf_counter()
            with record_function("mesh.ring_matrix_hop"):
                nbrs_a, seg_a, pos_a, totals, max_e = ring_matrix_hop(
                    self.mesh, placed, chunks, edge_cap)
                totals = host_np(totals)
            costprofile.note_launch(t0, time.perf_counter())
            return placed, nbrs_a, seg_a, pos_a, totals, int(max_e)

        placed, nbrs_a, seg_a, pos_a, totals, max_e = memgov.oom_retry(
            "mesh.ring_matrix_hop", (pred, reverse), _launch,
            mesh=self.mesh)
        if max_e > edge_cap:
            raise AssertionError(f"mesh.ring_matrix_hop: {max_e} edges in "
                                 f"a step past its cap {edge_cap}")
        self._note_mesh_shards(totals.sum(axis=1))
        top = max(int(totals.max()), 1)
        with record_function("engine.to_host"):
            cols = gather_columns([x.prefix(top)
                                   for x in (nbrs_a, seg_a, pos_a)])
            host = [[_to_host(*(col[dev][i, :int(totals[dev, i])]
                                for col in cols))
                     for i in range(d)] for dev in range(d)]
        nbrs, seg, pos = self._stitch_edge_parts(
            (host[dev][i][0], host[dev][i][1] + ((dev - i) % d) * per,
             host[dev][i][2], placed.pos_lo[dev])
            for dev in range(d) for i in range(d))
        keep = seg < len(frontier)  # drop chunk padding rows
        total = int(deg.sum())
        # each step every shard reads its resident chunk and writes its
        # (nbrs, seg, pos, valid) slots
        self.routes.add("mesh", total, d * d * 4 * f_cap
                        + 8 * len(frontier) + 4 * total
                        + d * d * 13 * edge_cap)
        return nbrs[keep], seg[keep], pos[keep]

    def facet_positions(self, sg: SubGraph, pos: np.ndarray) -> np.ndarray:
        """Edge positions in the forward-CSR space facet columns key on."""
        if sg.is_reverse:
            return self.store.rev_to_fwd_pos(sg.attr, pos)
        return pos

    # -- filters ------------------------------------------------------------
    def apply_filter(self, tree: FilterNode | None, universe: np.ndarray) -> np.ndarray:
        """Evaluate a filter tree restricted to `universe` (sorted ranks).
        Comparison/has leaves evaluate AGAINST the universe; other funcs
        materialize their set and intersect."""
        if tree is None:
            return universe
        if tree.op == "leaf":
            f = tree.func
            if f.name != "uid" and not f.is_val_var and not f.is_count:
                sub = eval_func_universe(self.store, f, universe)
                if sub is not None:
                    return sub
            return np.intersect1d(universe, self._leaf_set(tree.func, universe))
        if tree.op == "not":
            return np.setdiff1d(universe, self.apply_filter(tree.children[0], universe))
        parts = [self.apply_filter(c, universe) for c in tree.children]
        out = parts[0]
        for p in parts[1:]:
            out = np.intersect1d(out, p) if tree.op == "and" else np.union1d(out, p)
        return out.astype(np.int32)

    def filter_set(self, tree: FilterNode | None) -> np.ndarray | None:
        """A filter tree's allowed set WITHOUT a universe (index lookups
        only); None when the tree needs a complement (`not`). A tree that
        reads no variable is evaluated once per store
        (`Store.filter_set_memo`): a whole-store set such as `has(pred)`
        or a wide range costs tens of ms to build."""
        if tree is None:
            return None
        if _filter_uses(tree):
            return self._filter_set(tree)
        return self.store.filter_set_memo(
            repr(tree), lambda: self._filter_set(tree))

    def _filter_set(self, tree: FilterNode) -> np.ndarray | None:
        if tree.op == "leaf":
            return self._leaf_set(tree.func, EMPTY).astype(np.int32)
        if tree.op == "not":
            return None
        parts = [self._filter_set(c) for c in tree.children]
        if any(p is None for p in parts):
            return None
        out = parts[0]
        for p in parts[1:]:
            out = (np.intersect1d(out, p) if tree.op == "and"
                   else np.union1d(out, p))
        return out.astype(np.int32)

    def _var_ranks(self, name: str) -> np.ndarray:
        """uid(x): a uid var's ranks, or a val var's uid domain."""
        if name in self.uid_vars:
            return self.uid_vars[name]
        if name in self.val_vars:
            return np.array(sorted(self.val_vars[name]), np.int32)
        raise ValueError(f"variable {name!r} is used but not defined")

    def filter_edges(self, filters: FilterNode | None, nbrs: np.ndarray,
                     seg: np.ndarray, pos: np.ndarray | None = None):
        """Apply a filter tree to a flattened edge list, re-masking rows.
        Shared by plain expansion, @recurse, and shortest-path hops."""
        if pos is None:
            pos = EMPTY64
        if filters is None or not len(nbrs):
            return nbrs, seg, pos
        allowed = self.apply_filter(filters, np.unique(nbrs).astype(np.int32))
        keep = np.isin(nbrs, allowed)
        return nbrs[keep], seg[keep], (pos[keep] if len(pos) else pos)

    def _bind_facet_vars(self, sg: SubGraph, nbrs, pos) -> None:
        """@facets(v as key): value var keyed by CHILD rank; a child
        reached over several edges sums numeric facet values."""
        cols = self.store.edge_facets(
            sg.attr, self.facet_positions(sg, pos),
            [k for _, k in sg.facet_vars])
        for var, key in sg.facet_vars:
            vals = cols.get(key)
            m: dict = {}
            if vals is not None:
                for c, v in zip(nbrs.tolist(), vals):
                    if v is None:
                        continue
                    prev = m.get(c)
                    if (prev is not None and not isinstance(v, bool)
                            and isinstance(v, (int, float))
                            and isinstance(prev, (int, float))):
                        m[int(c)] = prev + v
                    else:
                        m[int(c)] = v
            self.val_vars[var] = m

    def facet_filter_edges(self, sg: SubGraph, pred: str,
                           nbrs: np.ndarray, seg: np.ndarray,
                           pos: np.ndarray):
        """@facets(eq(k, v) ...): drop edges whose facets fail the tree."""
        if sg.facet_filter is None or not len(nbrs):
            return nbrs, seg, pos
        keep = self._eval_facet_tree(sg.facet_filter, pred,
                                     self.facet_positions(sg, pos))
        return nbrs[keep], seg[keep], pos[keep]

    def _eval_facet_tree(self, tree: FilterNode, pred: str,
                         pos: np.ndarray) -> np.ndarray:
        if tree.op == "leaf":
            f = tree.func
            fvals = self.store.edge_facets(pred, pos, [f.attr]).get(
                f.attr, [None] * len(pos))
            want0 = f.args[0] if f.args else None
            out = np.zeros(len(pos), bool)
            for i, v in enumerate(fvals):
                if v is None:
                    continue
                want = _coerce_to(want0, v)
                try:
                    if f.name == "eq":
                        out[i] = v == want or str(v) == str(want)
                    elif f.name == "le":
                        out[i] = v <= want
                    elif f.name == "lt":
                        out[i] = v < want
                    elif f.name == "ge":
                        out[i] = v >= want
                    elif f.name == "gt":
                        out[i] = v > want
                except TypeError:
                    pass
            return out
        if tree.op == "not":
            return ~self._eval_facet_tree(tree.children[0], pred, pos)
        parts = [self._eval_facet_tree(c, pred, pos) for c in tree.children]
        out = parts[0]
        for p in parts[1:]:
            out = (out & p) if tree.op == "and" else (out | p)
        return out

    def _leaf_set(self, f: FuncNode, universe: np.ndarray) -> np.ndarray:
        if f.name == "uid" and (f.args or not f.uids):
            # mixed literals and variables: union both
            parts = [self._var_ranks(a) for a in f.args]
            if f.uids:
                r = self.store.rank_of(np.array(f.uids, np.int64))
                parts.append(r[r >= 0].astype(np.int32))
            return (np.unique(np.concatenate(parts)).astype(np.int32)
                    if parts else EMPTY)
        if f.name == "similar_to":
            # the routed k-NN seed (device or mesh top-k on a large tablet)
            return similar_ranks(self.store, f, self.device,
                                 self.device_threshold, mesh=self.mesh)
        return eval_func(self.store, f, self.val_vars)

    # -- root evaluation ----------------------------------------------------
    def root_ranks(self, sg: SubGraph) -> np.ndarray:
        f = sg.func
        if f is None:
            return EMPTY
        return self._leaf_set(f, EMPTY)

    # -- ordering / pagination ----------------------------------------------
    def _value_keys(self, ranks: np.ndarray, order: Order):
        """Sort keys for ranks by a value predicate or val-var. Missing
        values get a placeholder key (they sort last via the has-key)."""
        if order.is_val_var:
            var = self.val_vars.get(order.attr, {})
            vals = [var.get(int(r)) for r in ranks]
        elif not order.lang and (col := self.store.value_col(order.attr)) is not None:
            # vectorised first-value lookup on the sorted columnar pair
            ranks_arr = np.asarray(ranks, np.int32)
            idx = np.searchsorted(col.subj, ranks_arr)
            idx_c = np.minimum(idx, max(len(col.subj) - 1, 0))
            hit = (len(col.subj) > 0) & (col.subj[idx_c] == ranks_arr)
            vals = [col.vals[i] if h else None
                    for i, h in zip(idx_c.tolist(), np.atleast_1d(hit).tolist())]
        else:
            vals = []
            for r in ranks:
                vs = self.store.values_for(order.attr, int(r), order.lang)
                vals.append(vs[0] if vs else None)
        has = np.array([v is not None for v in vals], bool)
        present = [_orderable(v) for v in vals if v is not None]
        placeholder = present[0] if present else 0
        keys = np.array([_orderable(v) if v is not None else placeholder
                         for v in vals])
        return keys, has

    def order_ranks(self, ranks: np.ndarray, orders: list[Order],
                    seg: np.ndarray | None = None):
        """Stable multi-key ordering, optionally within segments (rows).
        lexsort priority: seg (row) > first order > ... > uid tiebreak."""
        if not orders:
            return np.arange(len(ranks))
        keys = [np.asarray(ranks)]  # lowest priority: uid tiebreak
        for o in reversed(orders):
            k, has = self._value_keys(ranks, o)
            if o.desc:
                k = _negate_key(k)
            keys.append(k)
            keys.append(~has)  # missing values last, asc or desc
        if seg is not None:
            keys.append(seg)
        return np.lexsort(tuple(keys))

    def _facet_order(self, sg: SubGraph, nbrs: np.ndarray, seg: np.ndarray,
                     pos: np.ndarray) -> np.ndarray:
        """Row-internal ordering by facet values (@facets(orderasc: k));
        edges without the facet sort last."""
        keys = [np.asarray(nbrs)]
        fpos = self.facet_positions(sg, pos)
        for o in reversed(sg.facet_orders):
            fvals = self.store.edge_facets(sg.attr, fpos, [o.attr]).get(
                o.attr, [None] * len(pos))
            has = np.array([v is not None for v in fvals], bool)
            present = [_orderable(v) for v in fvals if v is not None]
            placeholder = present[0] if present else 0
            k = np.array([_orderable(v) if v is not None else placeholder
                          for v in fvals])
            if o.desc:
                k = _negate_key(k)
            keys.append(k)
            keys.append(~has)
        keys.append(seg)
        return np.lexsort(tuple(keys))

    def paginate(self, arr_len: int, sg: SubGraph, ranks: np.ndarray) -> np.ndarray:
        """Row slice per first/offset/after → index array into the row."""
        idx = np.arange(arr_len)
        if sg.after:
            after_rank = self.store.rank_of(np.array([sg.after], np.int64))[0]
            idx = idx[ranks > after_rank] if after_rank >= 0 else idx
        if sg.offset:
            idx = idx[sg.offset:]
        if sg.first > 0:
            idx = idx[:sg.first]
        elif sg.first < 0:
            idx = idx[sg.first:]
        return idx

    # -- block execution ----------------------------------------------------
    def run_block(self, sg: SubGraph) -> LevelNode:
        """Execute one root block: as one whole-block program where
        `engine/fused.py` plans one, else level by level (the staged
        route). A deadline checkpoint ("block") runs first."""
        dl.checkpoint("block")
        with tracing.span("engine.block", block=sg.attr):
            return self._run_block(sg)

    def _run_block(self, sg: SubGraph) -> LevelNode:
        if sg.shortest is not None:
            from dgraph_tpu_torch.engine.shortest import shortest_path
            data = shortest_path(self, sg)
            node = LevelNode(sg=sg, nodes=data.nodes, path_data=data)
            if sg.var_name:
                self.uid_vars[sg.var_name] = data.nodes
            return node
        fused_node = self._run_fused(sg)
        if fused_node is not None:
            if needs_msgpass(sg):
                # the fused featprop stage binds its recurse level; any
                # other @msgpass level aggregates here
                annotate_tree(self, fused_node)
            return fused_node
        display = self.root_display(sg)
        nodes = np.unique(display).astype(np.int32)
        node = LevelNode(sg=sg, nodes=nodes, display=display.astype(np.int32))
        if sg.var_name:
            self.uid_vars[sg.var_name] = nodes
        if sg.groupby:
            node.groups = process_groupby(self, node)
            return node
        self._descend(node)
        if needs_msgpass(sg):
            annotate_tree(self, node)
        return node

    def _run_fused(self, sg: SubGraph) -> LevelNode | None:
        """The block as one whole-block program, or None for the staged
        route."""
        from dgraph_tpu_torch.engine.fused import try_fused
        return try_fused(self, sg)

    def root_display(self, sg: SubGraph) -> np.ndarray:
        """Root evaluation through ordering + pagination → the block's
        ordered display list."""
        ranks = self.root_ranks(sg)
        ranks = self.apply_filter(sg.filters, ranks)
        display = self._mesh_order_topk(sg, ranks)
        if display is None:
            order_idx = (self.order_ranks(ranks, sg.orders)
                         if sg.orders else np.arange(len(ranks)))
            display = ranks[order_idx]
        page = self.paginate(len(display), sg, display)
        return display[page].astype(np.int32)

    def _descend(self, parent: LevelNode) -> None:
        from dgraph_tpu_torch.engine.recurse import expand_recurse
        if parent.sg.recurse is not None:
            expand_recurse(self, parent)
            return
        for child_sg in self._concrete_children(parent):
            if self._expands(child_sg):
                parent.children.append(self.run_child(child_sg, parent.nodes))
            else:
                parent.leaf_sgs.append(child_sg)
                self._record_leaf_vars(child_sg, parent)

    def run_child(self, sg: SubGraph, frontier: np.ndarray) -> LevelNode:
        """Expand one uid-predicate child level below `frontier`."""
        nbrs, seg, pos, processed = self._level_edges(sg, frontier)
        return self._finish_child(sg, nbrs, seg, pos, processed)

    def _level_edges(self, sg: SubGraph, frontier: np.ndarray):
        """One child level's filtered edge list → (nbrs, seg, pos,
        processed); `processed` means pagination was already applied
        (the fused device route). Each level is a deadline checkpoint
        ("level"): a deep tree stops within one level of its budget."""
        dl.checkpoint("level")
        with tracing.span("engine.level", pred=sg.attr,
                          frontier=int(len(frontier))):
            fused = self._fused_level(sg, frontier)
            if fused is not None:
                return (*fused, True)
            nbrs, seg, pos = self.expand(
                sg.attr, sg.is_reverse, frontier,
                allow_remote=not _needs_facets(sg))
            nbrs, seg, pos = self.filter_edges(sg.filters, nbrs, seg, pos)
            nbrs, seg, pos = self.facet_filter_edges(sg, sg.attr, nbrs,
                                                     seg, pos)
            return nbrs, seg, pos, False

    def _finish_child(self, sg: SubGraph, nbrs, seg, pos,
                      processed: bool) -> LevelNode:
        """Ordering, per-row pagination, node building, var binding and
        descent below one expanded level."""
        if not processed:
            # row-internal ordering (default: uid order from the CSR)
            if sg.orders or sg.facet_orders:
                if sg.facet_orders:
                    order_idx = self._facet_order(sg, nbrs, seg, pos)
                else:
                    order_idx = self._mesh_row_order(sg, nbrs, seg)
                    if order_idx is None:
                        order_idx = self.order_ranks(nbrs, sg.orders,
                                                     seg=seg)
                nbrs, seg = nbrs[order_idx], seg[order_idx]
                pos = pos[order_idx] if len(pos) else pos
            # per-row pagination (seg is nondecreasing: CSR construction
            # order, preserved by masking; lexsort keys on seg first)
            if sg.first or sg.offset or sg.after:
                rows = np.unique(seg)
                starts = np.searchsorted(seg, rows)
                ends = np.searchsorted(seg, rows, "right")
                keep_idx = []
                for s, e in zip(starts.tolist(), ends.tolist()):
                    row_idx = np.arange(s, e)
                    keep_idx.append(
                        row_idx[self.paginate(e - s, sg, nbrs[row_idx])])
                if keep_idx:
                    keep_idx = np.sort(np.concatenate(keep_idx))
                    nbrs, seg = nbrs[keep_idx], seg[keep_idx]
                    pos = pos[keep_idx] if len(pos) else pos
        nodes = np.unique(nbrs).astype(np.int32)
        node = LevelNode(sg=sg, nodes=nodes,
                         matrix_seg=seg.astype(np.int32),
                         matrix_child=nbrs.astype(np.int32),
                         matrix_pos=pos)
        if sg.var_name:
            self.uid_vars[sg.var_name] = nodes
        if sg.facet_vars:
            self._bind_facet_vars(sg, nbrs, pos)
        if sg.groupby:
            node.groups = process_groupby_rows(self, node)
            return node
        self._descend(node)
        return node

    def _mesh_order_topk(self, sg: SubGraph, ranks: np.ndarray):
        """Root order-by on the mesh (the reference's SortOverNetwork): a
        single-key `orderasc`/`orderdesc` runs as per-shard top-k and a
        merge, capped when `first` bounds the result, full-length
        otherwise. The ordered display list, or None for the host."""
        if (self.mesh is None or len(sg.orders) != 1
                or sg.first < 0 or sg.after
                or len(ranks) < self.device_threshold):
            return None
        o = sg.orders[0]
        if o.is_val_var:
            return None
        from dgraph_tpu_torch.parallel.dsort import mesh_topk
        k = (sg.first + max(sg.offset, 0)) if sg.first else len(ranks)
        with lockstep(self.mesh, "mesh.order"):
            return mesh_topk(self.mesh, self.store, o.attr, o.lang, ranks,
                             k, desc=o.desc)

    def _mesh_row_order(self, sg: SubGraph, nbrs: np.ndarray,
                        seg: np.ndarray):
        """Child-level order-by on the mesh: the whole edge list sorted
        by (row, key, uid) in one program. None for the host lexsort."""
        if (self.mesh is None or len(sg.orders) != 1 or sg.facet_orders
                or len(nbrs) < self.device_threshold):
            return None
        o = sg.orders[0]
        if o.is_val_var:
            return None
        from dgraph_tpu_torch.parallel.dsort import mesh_row_sort
        with lockstep(self.mesh, "mesh.order"):
            return mesh_row_sort(self.mesh, self.store, o.attr, o.lang,
                                 nbrs, seg, desc=o.desc)

    def _fused_level(self, sg: SubGraph, frontier: np.ndarray):
        """Large-frontier route: expand → filter → paginate → dedupe in
        one device pass (ops.level.expand_level); the only host work is
        evaluating the filter tree to a sorted allowed set. Returns
        (nbrs, seg, pos) or None when ineligible (ordering, facet filters
        and `after` cursors need per-edge host logic)."""
        if (len(frontier) < self.device_threshold
                or sg.orders or sg.facet_orders or sg.after
                or sg.facet_filter is not None):
            return None
        rel = self.store.rel(sg.attr, sg.is_reverse)
        if len(frontier) == 0 or rel.nnz == 0:
            if rel.nnz:
                return None
            self.routes.add("empty", 0)
            return EMPTY, EMPTY, EMPTY64
        use_allowed = sg.filters is not None
        if use_allowed:
            # universe-free allowed set: index lookups only; complement-
            # shaped trees (`not`) take the gathered-neighbor route
            allowed = self.filter_set(sg.filters)
            if allowed is None:
                return None
        first = sg.first if sg.first else NO_LIMIT
        if self.mesh is not None:
            with lockstep(self.mesh, "mesh.level"):
                return self._fused_level_mesh(
                    sg, frontier, allowed if use_allowed else None, first)
        if use_allowed:
            allowed_d = _to_device(allowed, self.device)
        else:
            allowed_d = pad_to(EMPTY, 1, self.device)
        fr = _to_device(frontier, self.device)
        total = int(rel.degree(frontier).sum())
        ecap = _bucket(max(total, 1))
        indptr, indices = self.store.device_rel(sg.attr, sg.is_reverse,
                                                self.device)
        t0 = time.perf_counter()
        with record_function("level.expand_level"):
            c_nbrs, c_seg, c_pos, n_kept, _nxt, _nu, _total = expand_level(
                indptr, indices, fr, allowed_d, sg.offset, first,
                edge_cap=ecap, out_cap=ecap, use_allowed=use_allowed)
            n = int(n_kept)
        costprofile.note_launch(t0, time.perf_counter())
        nbrs, seg, pos = _to_host(c_nbrs[:n], c_seg[:n], c_pos[:n])
        # inputs as a gather plus the allowed set (when used); outputs:
        # kept nbrs, seg, pos and the deduped next frontier per slot
        a_bytes = 4 * allowed_d.shape[0] if use_allowed else 0
        self.routes.add("fused", n, _gather_bytes(
            len(frontier), fr.shape[0], total) + a_bytes + 16 * ecap)
        return nbrs, seg, pos.astype(np.int64)

    def _fused_level_mesh(self, sg: SubGraph, frontier: np.ndarray,
                          allowed, first: int):
        """The fused level on the mesh: expand, filter and paginate on
        every shard in one program (the reference's pushdown into each
        group's processTask); the host only stitches row order."""
        from dgraph_tpu_torch.parallel.dhop import matrix_level

        D = self.mesh.size
        srel = self.store.sharded_rel(sg.attr, sg.is_reverse, self.mesh)
        f_cap = _bucket(len(frontier))
        fr = _host_pad(frontier, f_cap)
        al = (_host_pad(allowed, _bucket(max(len(allowed), 1)))
              if allowed is not None else _host_pad(EMPTY, 1))
        deg = self.store.rel(sg.attr, sg.is_reverse).degree(frontier)
        edge_cap = self._shard_edge_cap(D, srel.rows_per_shard, frontier,
                                        deg)
        t0 = time.perf_counter()
        with record_function("mesh.matrix_level"):
            nbrs_s, seg_s, pos_s, kept, totals, max_shard = matrix_level(
                self.mesh, srel, fr, al, sg.offset, first, edge_cap,
                allowed is not None)
            kept, totals = host_np(kept, totals)
        costprofile.note_launch(t0, time.perf_counter())
        if int(max_shard) > edge_cap:
            raise AssertionError(f"mesh.matrix_level: {int(max_shard)} "
                                 f"edges on a shard past its cap {edge_cap}")
        self._note_mesh_shards(totals)
        self._count_mesh_route("fused")
        out = self._reassemble_shards(srel, nbrs_s, seg_s, pos_s, kept)
        total = int(deg.sum())
        a_bytes = 4 * len(al) * D if allowed is not None else 0
        # as the mesh gather, plus the allowed set each shard reads and
        # the kept (nbrs, seg, pos) plus the masked nbrs it writes
        self.routes.add("mesh_level", len(out[0]), D * 4 * f_cap
                        + 8 * len(frontier) + 4 * total + a_bytes
                        + D * 16 * edge_cap)
        return out

    # -- leaves, vars, expand(_all_) ----------------------------------------
    def _concrete_children(self, parent: LevelNode) -> list[SubGraph]:
        """Resolve expand(_all_)/expand(Type) into concrete child blocks."""
        out: list[SubGraph] = []
        for c in parent.sg.children:
            if not c.is_expand_all:
                out.append(c)
                continue
            if c.expand_arg and c.expand_arg != "_all_":
                preds = self.store.predicates_of_types([c.expand_arg])
            else:
                type_names: set[str] = set()
                for r in parent.nodes:
                    type_names.update(
                        self.store.values_for("dgraph.type", int(r)))
                preds = self.store.predicates_of_types(sorted(type_names))
            for p in preds:
                ps = self.store.schema.peek(p)
                if ps and ps.kind == Kind.UID:
                    out.append(SubGraph(attr=p, children=list(c.children)))
                else:
                    out.append(SubGraph(attr=p))
        return out

    def _expands(self, sg: SubGraph) -> bool:
        return expands(self.store.schema, sg)

    def _record_leaf_vars(self, sg: SubGraph, parent: LevelNode) -> None:
        """Bind value/count vars declared on leaves (a as age, c as count(p))."""
        if not sg.var_name:
            return
        if sg.is_uid_leaf and not sg.is_count:
            # `v as uid` binds the enclosing block's uid set
            self.uid_vars[sg.var_name] = parent.nodes
            return
        if sg.is_count:
            rel = self.store.rel(sg.attr, sg.is_reverse)
            deg = rel.degree(parent.nodes)
            self.val_vars[sg.var_name] = {
                int(r): int(d) for r, d in zip(parent.nodes, deg)}
        elif sg.math_expr is not None:
            self.val_vars[sg.var_name] = eval_math(
                sg.math_expr, parent.nodes, self.val_vars)
        elif sg.is_val_leaf:
            src = self.val_vars.get(sg.attr, {})
            self.val_vars[sg.var_name] = {
                int(r): src[int(r)] for r in parent.nodes if int(r) in src}
        else:
            env: dict[int, object] = {}
            for r in parent.nodes:
                vs = self.store.values_for(sg.attr, int(r), sg.lang)
                if vs:
                    env[int(r)] = vs[0]
            self.val_vars[sg.var_name] = env


def _needs_facets(sg) -> bool:
    """Whether a block consumes edge positions (facet render/filter/order)."""
    return (sg.facet_keys is not None or sg.facet_filter is not None
            or sg.facet_vars is not None or bool(sg.facet_orders))


def expands(schema, sg: SubGraph) -> bool:
    """Whether a child block triggers uid expansion (vs a value leaf).
    Shared by the executor and the batch planner."""
    if (sg.is_count or sg.is_uid_leaf or sg.is_agg or sg.is_val_leaf
            or sg.math_expr is not None):
        return False
    if sg.is_reverse or sg.children or sg.recurse or sg.shortest:
        return True
    ps = schema.peek(sg.attr)
    return bool(ps and ps.kind == Kind.UID)


def _coerce_to(want, v):
    """Coerce a parsed (string) comparison arg to the facet value's type."""
    if not isinstance(want, str):
        return want
    try:
        if isinstance(v, (bool, np.bool_)):
            return want.strip().lower() in ("true", "1")
        if isinstance(v, (int, np.integer)):
            return int(want)
        if isinstance(v, (float, np.floating)):
            return float(want)
    except ValueError:
        pass
    return want


def _orderable(v):
    if isinstance(v, np.datetime64):
        return v.astype("datetime64[us]").astype("int64")
    if isinstance(v, (bool, np.bool_)):
        return int(v)
    return v


def _negate_key(k: np.ndarray) -> np.ndarray:
    if k.dtype.kind in "if":
        return -k
    # strings: lexsort can't negate; invert via rank mapping
    uniq, inv = np.unique(k, return_inverse=True)
    return (len(uniq) - 1 - inv).astype(np.int64)
