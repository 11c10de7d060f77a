"""The posting store: uid vocabulary + per-predicate CSR blocks.

Port of `dgraph_tpu/store/store.py`: `EdgeRel`, `ValueColumn`,
`FacetCol`, `PredicateData`, `Store`, `StoreBuilder`, `build_indexes`
and the CSR builder, over the same dense int32 rank space:

    uids[int64, N]            sorted global uid vocabulary (rank = position)
    indptr[int32, N+1]        per-predicate row offsets
    indices[int32, nnz]       object ranks, sorted within each row

The host arrays are numpy and equal to the reference's for the same
input. The per-query engine reads each CSR on the device through
`Store.device_rel` (cached per predicate, direction and device); the
batched path places its ELL layout itself (`ops/bfs.py:device_ell`).
CSR construction takes the native builder (`native/csr.cpp`), which
gives the numpy builder's arrays bit for bit. A store also memoizes the
filter sets that depend on it alone (`Store.filter_set_memo`). Value columns hold
every scalar kind (geo values as `GeoVal`, passwords as their hashes,
float32vector values as 1-D float32 rows of an object column), and
`build_indexes` keys exact, hash, term, fulltext, trigram and geo tokens.
A float32vector predicate's rows stack into a `store/vec.VecTablet`
(`Store.vec_tablet`), placed on a device once (`Store.vec_device`).
Both device caches are governed (`utils/memgov.py`: `store.device` and
`store.vec` under the device budget): an evicted entry is placed again
on next use and counted (`cache_replacements_total{cache=
"store.device"}`, `vec_replacements_total{kind="device"}`), and the
whole-block programs that read an evicted entry's tensors are dropped
with it (`engine/fused.py`). On a mesh (`parallel/mesh.py`) a CSR is
placed row-sharded once per (predicate, direction) for one mesh
(`Store.sharded_rel`, governed as `store.sharded`, charged the bytes
its shard tensors hold; a placement updates the gauges
`mesh_shard_bytes{shard=}` and `mesh_shard_balance`), and an embedding
stack once per predicate (`Store.vec_sharded`, under `store.vec`). A
placement for another mesh drops the entries of the old one; an
evicted entry is placed again on next use
(`cache_replacements_total{cache="store.sharded"}`,
`vec_replacements_total{kind="mesh"}`). Over a mesh that spans
processes a placement puts this process's shards only, and makes no
collective: one rank's eviction and re-placement cannot put the ranks
out of step.

`store_from_arrays` builds a port Store from a reference Store's numpy
state (or plain arrays), so both packages can be handed the same data.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch import native
from dgraph_tpu_torch.store.geo import parse_geo
from dgraph_tpu_torch.store.schema import PredicateSchema, Schema, parse_schema
from dgraph_tpu_torch.store.tok import tokens_for
from dgraph_tpu_torch.store.types import NUMPY_DTYPE, Kind, convert
from dgraph_tpu_torch.utils import memgov
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dgraph_tpu_torch.utils.metrics import METRICS
from dgraph_tpu_torch.utils import locks

TYPE_PRED = "dgraph.type"
FILTER_SET_CAPACITY = 64   # memoized filter sets per store, LRU


@dataclass
class EdgeRel:
    """One direction of a uid predicate as CSR over rank space."""

    indptr: np.ndarray  # int32 [N+1]
    indices: np.ndarray  # int32 [nnz], sorted within each row

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degree(self, ranks: np.ndarray) -> np.ndarray:
        return self.indptr[ranks + 1] - self.indptr[ranks]

    def row(self, rank: int) -> np.ndarray:
        return self.indices[self.indptr[rank]:self.indptr[rank + 1]]


@dataclass
class ValueColumn:
    """Scalar predicate values, columnar, sorted by subject rank.
    `subj` may repeat for list-valued predicates."""

    subj: np.ndarray  # int32 [k] sorted
    vals: np.ndarray  # typed per schema kind

    def get(self, rank: int) -> list:
        # the key in the column's dtype: a Python int would make numpy
        # cast the whole column to int64 on every call
        r = self.subj.dtype.type(rank)
        lo = np.searchsorted(self.subj, r, side="left")
        hi = np.searchsorted(self.subj, r, side="right")
        return list(self.vals[lo:hi])

    def get_many(self, ranks: np.ndarray) -> dict[int, list]:
        """Values for a whole batch of ranks in two searchsorted calls;
        ranks with no value are absent from the result."""
        ranks = np.asarray(ranks)
        lo = np.searchsorted(self.subj, ranks, side="left")
        hi = np.searchsorted(self.subj, ranks, side="right")
        out: dict[int, list] = {}
        single = (hi - lo) == 1  # the common, fully-vectorizable case
        if single.any():
            # iterate the numpy array, NOT .tolist(): tolist() would
            # down-convert np scalars (datetime64 → datetime) and change
            # downstream JSON rendering
            out.update((int(r), [v]) for r, v in
                       zip(ranks[single].tolist(), self.vals[lo[single]]))
        multi = (hi - lo) > 1
        for r, l, h in zip(ranks[multi].tolist(), lo[multi].tolist(),
                           hi[multi].tolist()):
            out[int(r)] = list(self.vals[l:h])
        return out

    def has(self) -> np.ndarray:
        """Sorted unique ranks that have a value."""
        return np.unique(self.subj)


@dataclass
class FacetCol:
    """Edge facets for one key, columnar by forward edge position (the
    positions the hop's `edge_pos` output gathers from)."""

    pos: np.ndarray   # sorted int64 positions into fwd.indices
    vals: np.ndarray  # object array of facet values

    def _locate(self, positions: np.ndarray):
        """(clamped indexes, hit mask) for edge positions."""
        idx = np.searchsorted(self.pos, positions)
        idx_c = np.minimum(idx, max(len(self.pos) - 1, 0))
        hit = (len(self.pos) > 0) & (self.pos[idx_c] == positions)
        return np.atleast_1d(idx_c), np.atleast_1d(hit)

    def get(self, positions: np.ndarray) -> list:
        """Facet values at edge positions; None where absent."""
        idx_c, hit = self._locate(positions)
        return [self.vals[i] if h else None
                for i, h in zip(idx_c.tolist(), hit.tolist())]

    def numeric_at(self, positions: np.ndarray):
        """(values float64, hit mask) at edge positions, or None unless
        EVERY value is genuinely numeric (numeric strings do not parse:
        the per-value path weighs them 1, and the two must agree)."""
        if not hasattr(self, "_num"):
            if all(isinstance(v, (bool, int, float, np.integer,
                                  np.floating, np.bool_))
                   for v in self.vals):
                self._num = self.vals.astype(np.float64)
            else:
                self._num = None
        if self._num is None or not len(self.pos):
            return None
        idx_c, hit = self._locate(positions)
        return self._num[idx_c], hit


@dataclass
class PredicateData:
    schema: PredicateSchema
    fwd: EdgeRel | None = None
    rev: EdgeRel | None = None
    # lang tag → column; "" is the untagged default column
    vals: dict[str, ValueColumn] = field(default_factory=dict)
    # tokenizer → token → sorted int32 rank array
    index: dict[str, dict[str, np.ndarray]] = field(default_factory=dict)
    # facet key → edge-position column (forward direction)
    efacets: dict[str, FacetCol] = field(default_factory=dict)
    # facet key → {subject rank: value} for value postings
    vfacets: dict[str, dict[int, object]] = field(default_factory=dict)
    # reverse-CSR position → forward-CSR position: facets live on the
    # forward posting but also render on ~pred expansions
    rev_pos: np.ndarray | None = None

    def build_rev_pos(self, n: int) -> None:
        if self.rev is None or self.fwd is None or not self.rev.nnz:
            return
        o_arr = np.repeat(np.arange(n, dtype=np.int64),
                          np.diff(self.rev.indptr).astype(np.int64))
        s_arr = self.rev.indices.astype(np.int64)
        # both CSRs are sorted by (subject, object), so the flattened
        # (s * n + o) keys of the forward edges are ascending
        self.rev_pos = np.searchsorted(_edge_keys(self.fwd, n),
                                       s_arr * n + o_arr)


def _edge_keys(rel: EdgeRel, n: int) -> np.ndarray:
    """Ascending (subject * n + object) key of every edge of a CSR."""
    src = np.repeat(np.arange(n, dtype=np.int64),
                    np.diff(rel.indptr).astype(np.int64))
    return src * n + rel.indices.astype(np.int64)


def _vec_detail(store) -> list:
    """Resident vector stacks with their dims (`GOVERNOR.status()` rows
    that make eviction thrash on `store.vec` visible)."""
    out = []
    for (pred, kind), v in sorted(store._vec_dev.items()):
        if kind == "mesh":
            _subj, vecs, rows = v
            out.append({"pred": pred, "placement": "mesh",
                        "shards": len(vecs.parts), "rows": int(rows),
                        "dim": int(vecs.lead.shape[-1])})
        else:
            _subj, vecs = v
            out.append({"pred": pred, "placement": "device",
                        "rows": int(vecs.shape[0]),
                        "dim": int(vecs.shape[1])})
    return out


class Store:
    """Immutable posting-store snapshot (host arrays + device cache)."""

    def __init__(self, uids: np.ndarray, schema: Schema,
                 preds: dict[str, PredicateData]):
        if uids.dtype != np.int64 or not np.all(np.diff(uids) > 0):
            raise ValueError("uids must be strictly increasing int64")
        self.uids = uids
        self.schema = schema
        self.preds = preds
        # (pred, direction, device) → (indptr, indices) int32 tensors
        self._device: dict = {}
        # (pred, direction) → parallel/pshard.ShardedRel placed on
        # `_sharded_mesh`; per-shard resident bytes and true edges of
        # the placed tablets (the residency gauges)
        self._sharded: dict = {}
        self._sharded_mesh = None
        self._mesh_shard_bytes = None
        self._mesh_shard_nnz = None
        # (pred, lang) → the mesh's sort-key columns (parallel/dsort.py)
        self._key_cols: dict = {}
        self._key_cols_mesh = None
        self._vec_mesh = None
        self._empty_rel = EdgeRel(np.zeros(self.n_nodes + 1, np.int32),
                                  np.zeros(0, np.int32))
        self._filter_sets: OrderedDict = OrderedDict()
        self._filter_lock = locks.make_lock("store.filter")
        # float32vector tablets: host stacks built from the value column,
        # and their (subj, vecs) tensors per (predicate, device)
        self._vec_tab: dict = {}
        self._vec_dev: dict = {}
        # keys ever placed: placing one again is a RE-placement (the
        # governor evicted it), counted so eviction thrash is visible
        self._placed: set = set()
        # request threads place concurrently: one placement per key
        self._place_lock = locks.make_lock("store.place")
        # both device caches join the governor's device budget; an
        # evicted entry is placed again on next use, and a launch that
        # already holds its tensors keeps them
        memgov.govern_dict(self, "_device", "store.device", "device")
        memgov.govern_dict(self, "_sharded", "store.sharded", "device")
        memgov.govern_dict(self, "_vec_dev", "store.vec", "device",
                           detail_cb=_vec_detail)
        locks.guarded(self, "store.filter")

    def filter_set_memo(self, key, compute):
        """The allowed set `compute()` gives for a filter tree that reads
        no variable, memoized under `key` (the tree's repr): its answer
        is fixed for this snapshot. Callers share the array and only read
        it. LRU of `FILTER_SET_CAPACITY`; a None answer is not kept."""
        with self._filter_lock:
            out = self._filter_sets.get(key)
            if out is not None:
                self._filter_sets.move_to_end(key)
                return out
        out = compute()
        if out is None:
            return None
        with self._filter_lock:
            # graftlint: allow(split-critical-section): idempotent memo fill — the answer for a key is fixed for this snapshot, so a concurrent filler installs an equal array
            self._filter_sets[key] = out
            while len(self._filter_sets) > FILTER_SET_CAPACITY:
                self._filter_sets.popitem(last=False)
        return out

    def rev_to_fwd_pos(self, pred: str, pos: np.ndarray) -> np.ndarray:
        """Map reverse-CSR edge positions to their forward positions (the
        space facet columns key on). Built lazily per predicate."""
        pd = self.preds.get(pred)
        if pd is None or not len(pos):
            return pos
        if pd.rev_pos is None:
            pd.build_rev_pos(self.n_nodes)
        return pd.rev_pos[pos] if pd.rev_pos is not None else pos

    # -- uid ↔ rank ---------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return int(self.uids.shape[0])

    def rank_of(self, uid_arr) -> np.ndarray:
        """Global uids → ranks; -1 for unknown uids."""
        uid_arr = np.asarray(uid_arr, np.int64)
        pos = np.searchsorted(self.uids, uid_arr)
        pos_c = np.minimum(pos, self.n_nodes - 1) if self.n_nodes else pos * 0
        ok = self.n_nodes > 0
        hit = ok & (self.uids[pos_c] == uid_arr) if ok else np.zeros_like(uid_arr, bool)
        return np.where(hit, pos_c, -1).astype(np.int32)

    def uid_of(self, ranks) -> np.ndarray:
        return self.uids[np.asarray(ranks)]

    # -- relations ----------------------------------------------------------
    def rel(self, pred: str, reverse: bool = False) -> EdgeRel:
        p = self.preds.get(pred)
        r = (p.rev if reverse else p.fwd) if p else None
        return r if r is not None else self._empty_rel

    def device_rel(self, pred: str, reverse: bool = False,
                   device=DEFAULT_DEVICE):
        """(indptr, indices) of one CSR as int32 tensors on `device`,
        placed once per (predicate, direction, device)."""
        dev = resolve_device(device)
        key = (pred, "rev" if reverse else "fwd", str(dev))
        out = self._device.get(key)
        if out is None:
            with self._place_lock:
                out = self._device.get(key)
                placed = out is None
                if placed:
                    r = self.rel(pred, reverse)
                    out = self._device[key] = (
                        torch.from_numpy(r.indptr).to(dev),
                        torch.from_numpy(r.indices).to(dev))
            if placed:
                self._note_placed(("device",) + key, lambda: METRICS.inc(
                    "cache_replacements_total", cache="store.device"))
        return out

    def sharded_rel(self, pred: str, reverse: bool, mesh):
        """One CSR row-sharded over `mesh` (`parallel/pshard.py`), placed
        once per (predicate, direction) for that mesh: the tablet
        residency of the mesh routes. A placement for another mesh drops
        the old mesh's entries."""
        from dgraph_tpu_torch.parallel.pshard import device_put_rel, shard_rel
        key = (pred, "rev" if reverse else "fwd")
        out = self._sharded.get(key) if self._sharded_mesh is mesh else None
        if out is not None:
            return out
        with self._place_lock:
            if self._sharded_mesh is not mesh:
                self._sharded = {}
                self._sharded_mesh = mesh
                self._mesh_shard_bytes = self._mesh_shard_nnz = None
            cache = self._sharded
            out = cache.get(key)
            placed = out is None
            if placed:
                host = shard_rel(self.rel(pred, reverse), mesh.size)
                out = cache[key] = device_put_rel(host, mesh)
                self._note_mesh_residency(host)
        if placed:
            self._note_placed(("sharded", id(mesh)) + key,
                              lambda: METRICS.inc("cache_replacements_total",
                                                  cache="store.sharded"))
        return out

    def _note_mesh_residency(self, srel) -> None:
        """Residency gauges for a newly placed sharded tablet (host form
        of it): `mesh_shard_bytes{shard=}` sums each shard's resident
        bytes over this snapshot's placed tablets (padded widths: what
        the device holds), `mesh_shard_balance` is max/mean TRUE edges
        per shard (1.0 = balanced; padding hides imbalance from the
        bytes gauge). Caller holds `_place_lock`."""
        ptr = np.asarray(srel.indptr_s)
        d = ptr.shape[0]
        per_bytes = (ptr[0].nbytes + np.asarray(srel.indices_s[0]).nbytes
                     + 4)
        nnz = ptr[:, -1].astype(np.int64)
        if self._mesh_shard_bytes is None or \
                len(self._mesh_shard_bytes) != d:
            self._mesh_shard_bytes = np.zeros(d, np.int64)
            self._mesh_shard_nnz = np.zeros(d, np.int64)
        self._mesh_shard_bytes += per_bytes
        self._mesh_shard_nnz += nnz
        for s in range(d):
            METRICS.set_gauge("mesh_shard_bytes",
                              float(self._mesh_shard_bytes[s]), shard=s)
        mean = float(self._mesh_shard_nnz.mean())
        if mean > 0:
            METRICS.set_gauge("mesh_shard_balance",
                              float(self._mesh_shard_nnz.max()) / mean)

    def key_col_host(self, pred: str) -> "Store":
        """The store whose cache holds `pred`'s mesh sort-key column
        (`parallel/dsort.py`): this one (an ACL view answers for the
        predicates it shares with its snapshot)."""
        return self

    def _note_placed(self, key, count) -> None:
        """Count a re-placement (`count()`), then let the governor evict
        above the device budget's high watermark. The caller returns the
        tensors it placed even if this pass evicts them: its launch holds
        them, and the next lookup places them again."""
        if key in self._placed:
            count()
        self._placed.add(key)
        memgov.GOVERNOR.maybe_evict("device")

    # -- vector tablets -----------------------------------------------------
    def vec_tablet(self, pred: str):
        """Host `[n, d]` embedding stack of a float32vector predicate,
        built from the value column at first use and kept on this
        snapshot. None for other predicates."""
        t = self._vec_tab.get(pred)
        if t is None:
            ps = self.schema.peek(pred)
            if ps is None or ps.kind != Kind.VECTOR:
                return None
            from dgraph_tpu_torch.store import vec as _vec
            t = self._vec_tab[pred] = _vec.build_tablet(
                self.value_col(pred), ps.vector_dim)
        return t

    def vec_device(self, pred: str, device=DEFAULT_DEVICE):
        """(subj int32, vecs float32) tensors of a float32vector
        predicate's tablet on `device`, placed once per (predicate,
        device)."""
        dev = resolve_device(device)
        key = (pred, str(dev))
        out = self._vec_dev.get(key)
        if out is None:
            t = self.vec_tablet(pred)
            with self._place_lock:
                out = self._vec_dev.get(key)
                placed = out is None
                if placed:
                    out = self._vec_dev[key] = (
                        torch.from_numpy(t.subj).to(dev),
                        torch.from_numpy(t.vecs).to(dev))
            if placed:
                self._note_placed(("vec",) + key, lambda: METRICS.inc(
                    "vec_replacements_total", kind="device"))
        return out

    def vec_sharded(self, pred: str, mesh):
        """A float32vector predicate's stack row-sharded over `mesh`:
        shard d holds rows [d·R, (d+1)·R) of the tablet (R = ceil(rows /
        D); the last shards may hold fewer, or none), placed once per
        predicate for that mesh under `store.vec`. Returns (subj
        Sharded, vecs Sharded, R)."""
        from dgraph_tpu_torch.parallel.mesh import shard
        key = (pred, "mesh")
        out = self._vec_dev.get(key) if self._vec_mesh is mesh else None
        if out is not None:
            return out
        t = self.vec_tablet(pred)
        with self._place_lock:
            cache = self._vec_dev
            if self._vec_mesh is not mesh:
                for k in [k for k in cache if k[1] == "mesh"]:
                    cache.pop(k, None)
                self._vec_mesh = mesh
            out = cache.get(key)
            placed = out is None
            if placed:
                d = mesh.size
                rows = -(-max(t.rows, 1) // d)
                cut = [min(i * rows, t.rows) for i in range(d + 1)]
                subj = shard(mesh, [torch.from_numpy(t.subj[a:b])
                                    for a, b in zip(cut, cut[1:])])
                vecs = shard(mesh, [torch.from_numpy(t.vecs[a:b])
                                    for a, b in zip(cut, cut[1:])])
                out = cache[key] = (subj, vecs, rows)
        if placed:
            self._note_placed(("vec", id(mesh)) + key, lambda: METRICS.inc(
                "vec_replacements_total", kind="mesh"))
        return out

    # -- values -------------------------------------------------------------
    def value_col(self, pred: str, lang: str = "") -> ValueColumn | None:
        p = self.preds.get(pred)
        if not p:
            return None
        return p.vals.get(lang)

    def values_for(self, pred: str, rank: int, lang: str = "") -> list:
        """Values of `pred` on `rank`. `lang` may be a fallback chain like
        "en:fr:." ("." = any language, untagged preferred)."""
        if not lang:
            col = self.value_col(pred, "")
            return col.get(rank) if col is not None else []
        pd = self.preds.get(pred)
        for l in lang.split(":"):
            if l == ".":
                langs = [""] + sorted(k for k in (pd.vals if pd else {})
                                      if k)
            else:
                langs = [l]
            for lk in langs:
                col = self.value_col(pred, lk)
                if col is not None:
                    vs = col.get(rank)
                    if vs:
                        return vs
        return []

    def values_for_many(self, pred: str, ranks: np.ndarray,
                        lang: str = "") -> dict[int, list]:
        """Batched values_for over a rank set, with values_for's per-rank
        lang-chain fallback semantics."""
        ranks = np.asarray(ranks)
        if not lang:
            col = self.value_col(pred, "")
            return col.get_many(ranks) if col is not None else {}
        pd = self.preds.get(pred)
        out: dict[int, list] = {}
        remaining = ranks
        for l in lang.split(":"):
            if not len(remaining):
                break
            if l == ".":
                langs = [""] + sorted(k for k in (pd.vals if pd else {})
                                      if k)
            else:
                langs = [l]
            for lk in langs:
                if not len(remaining):
                    break
                col = self.value_col(pred, lk)
                if col is None:
                    continue
                got = col.get_many(remaining)
                if got:
                    out.update(got)
                    keep = np.array([r not in got
                                     for r in remaining.tolist()])
                    remaining = remaining[keep]
        return out

    def has_ranks(self, pred: str) -> np.ndarray:
        """Sorted ranks of subjects that have `pred` (edges or values);
        `~pred` counts incoming edges."""
        reverse = pred.startswith("~")
        p = self.preds.get(pred.lstrip("~"))
        if not p:
            return np.zeros(0, np.int32)
        if reverse:
            rel = p.rev
            if rel is None:
                return np.zeros(0, np.int32)
            deg = rel.indptr[1:] - rel.indptr[:-1]
            return np.nonzero(deg > 0)[0].astype(np.int32)
        parts = []
        if p.fwd is not None:
            deg = p.fwd.indptr[1:] - p.fwd.indptr[:-1]
            parts.append(np.nonzero(deg > 0)[0].astype(np.int32))
        for col in p.vals.values():
            parts.append(col.has().astype(np.int32))
        if not parts:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(parts))

    # -- facets -------------------------------------------------------------
    def edge_facets(self, pred: str, positions: np.ndarray,
                    keys=None) -> dict[str, list]:
        """Facet values per requested key at forward edge positions;
        `keys=None` → every key present."""
        p = self.preds.get(pred)
        if not p or not p.efacets:
            return {}
        use = p.efacets.keys() if keys is None else \
            [k for k in keys if k in p.efacets]
        return {k: p.efacets[k].get(np.asarray(positions, np.int64))
                for k in use}

    def value_facets(self, pred: str, rank: int, keys=None) -> dict:
        """Facets on a value posting."""
        p = self.preds.get(pred)
        if not p or not p.vfacets:
            return {}
        use = p.vfacets.keys() if keys is None else \
            [k for k in keys if k in p.vfacets]
        out = {}
        for k in use:
            if rank in p.vfacets[k]:
                out[k] = p.vfacets[k][rank]
        return out

    def index_lookup(self, pred: str, tokenizer: str, token: str) -> np.ndarray:
        """token → sorted rank posting list."""
        p = self.preds.get(pred)
        if not p:
            return np.zeros(0, np.int32)
        return p.index.get(tokenizer, {}).get(token, np.zeros(0, np.int32))

    def predicates_of_types(self, type_names) -> list[str]:
        fields: list[str] = []
        for t in type_names:
            td = self.schema.types.get(t)
            if td:
                fields.extend(td.fields)
        seen = set()
        return [f for f in fields if not (f in seen or seen.add(f))]


class StoreBuilder:
    """Accumulates triples, then finalizes into an immutable Store (the
    reference's bulk-load reduce phase: group edges by predicate, sort,
    emit CSR + columnar values + inverted indexes)."""

    def __init__(self, schema: Schema | None = None):
        self.schema = schema or Schema()
        self.schema.get(TYPE_PRED).kind = Kind.STRING
        self.schema.get(TYPE_PRED).is_list = True
        if not self.schema.get(TYPE_PRED).index_tokenizers:
            self.schema.get(TYPE_PRED).index_tokenizers = ("exact",)
        # per predicate: list of (subj, obj) uid column pairs
        self._edges: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {}
        self._values: dict[tuple[str, str], list[tuple[int, object]]] = {}
        # uid columns from bulk adds, single uids from per-triple adds
        self._known_uids: list[np.ndarray] = []
        self._known_one: list[int] = []
        # facets keyed by the (subject, object) uid pair / subject uid;
        # a later add replaces the pair's whole facet map
        self._efacets: dict[str, dict[tuple[int, int], dict]] = {}
        self._vfacets: dict[str, dict[int, dict]] = {}

    def _uid_pred(self, pred: str) -> None:
        ps = self.schema.get(pred)
        if ps.kind == Kind.DEFAULT and not any(
                p == pred for p, _ in self._values):
            ps.kind = Kind.UID
        elif ps.kind != Kind.UID:
            raise ValueError(
                f"predicate {pred!r} holds {ps.kind} values, not uids")

    def add_edge(self, subj: int, pred: str, obj: int,
                 facets: dict | None = None) -> None:
        self.add_edges(pred, [subj], [obj])
        if facets:
            self._efacets.setdefault(pred, {})[(int(subj), int(obj))] = \
                dict(facets)

    def add_edges(self, pred: str, subjs, objs) -> None:
        """Vectorised bulk form of add_edge (no facets)."""
        self._uid_pred(pred)
        subjs = np.asarray(subjs, np.int64)
        objs = np.asarray(objs, np.int64)
        self._edges.setdefault(pred, []).append((subjs, objs))
        self._known_uids.extend((subjs, objs))

    def touch(self, uid: int) -> None:
        """Register a uid in the vocabulary without any posting."""
        self._known_one.append(int(uid))

    def touch_many(self, uids) -> None:
        self._known_uids.append(np.asarray(uids, np.int64).reshape(-1))

    def add_value(self, subj: int, pred: str, value, lang: str = "",
                  facets: dict | None = None) -> None:
        ps = self.schema.get(pred)
        if ps.kind == Kind.UID or pred in self._edges:
            raise ValueError(f"predicate {pred!r} is a uid predicate")
        if ps.kind == Kind.DEFAULT and not isinstance(value, str):
            # auto-type from first value (reference: first-mutation typing)
            if isinstance(value, bool):
                ps.kind = Kind.BOOL
            elif isinstance(value, int):
                ps.kind = Kind.INT
            elif isinstance(value, float):
                ps.kind = Kind.FLOAT
        if ps.kind == Kind.VECTOR:
            # converted now, so a width mismatch is refused at load time,
            # not found mid-query; the first vector fixes the width when
            # the schema has no @dim
            value = convert(value, Kind.VECTOR)
            if ps.vector_dim == 0:
                ps.vector_dim = int(len(value))
            elif len(value) != ps.vector_dim:
                raise ValueError(
                    f"predicate {pred!r}: vector of dim {len(value)} "
                    f"does not match schema dim {ps.vector_dim}")
        self._values.setdefault((pred, lang), []).append((subj, value))
        if facets:
            self._vfacets.setdefault(pred, {})[subj] = dict(facets)
        self._known_one.append(int(subj))

    def add_type(self, subj: int, type_name: str) -> None:
        self.add_value(subj, TYPE_PRED, type_name)

    def finalize(self) -> Store:
        parts = self._known_uids + [np.array(self._known_one, np.int64)]
        uids = np.unique(np.concatenate(parts))
        n = len(uids)

        def rank(u):
            return np.searchsorted(uids, u).astype(np.int32)

        preds: dict[str, PredicateData] = {}
        for pred, cols in self._edges.items():
            ps = self.schema.get(pred)
            pd = preds.setdefault(pred, PredicateData(schema=ps))
            s = rank(np.concatenate([c[0] for c in cols]))
            o = rank(np.concatenate([c[1] for c in cols]))
            pd.fwd = _csr_from_pairs(s, o, n)
            if ps.reverse:
                pd.rev = _csr_from_pairs(o, s, n)
            fmap = self._efacets.get(pred)
            if fmap:
                pd.efacets = _facet_cols(pd.fwd, fmap, rank, n)

        for (pred, lang), pairs in self._values.items():
            ps = self.schema.get(pred)
            pd = preds.setdefault(pred, PredicateData(schema=ps))
            kind = ps.kind if ps.kind != Kind.DEFAULT else Kind.STRING
            ranks = rank(np.array([s for s, _ in pairs], np.int64))
            # dedupe exact (subj, value) repeats (posting lists are
            # sets); keep list multiplicity for distinct values only
            seen: set = set()
            dpairs = []
            for r, (_s, v) in zip(ranks.tolist(), pairs):
                cv = convert(v, kind)
                if isinstance(cv, np.datetime64):
                    key = (r, cv.astype("int64").item())
                elif isinstance(cv, np.ndarray):    # vectors: hash bytes
                    key = (r, cv.tobytes())
                else:
                    key = (r, cv)
                if key in seen:
                    continue
                seen.add(key)
                dpairs.append((r, cv))
            subj = np.array([s for s, _ in dpairs], np.int32)
            order = np.argsort(subj, kind="stable")
            subj = subj[order]
            vals = np.empty(len(dpairs), dtype=NUMPY_DTYPE[kind])
            for i, j in enumerate(order):
                vals[i] = dpairs[j][1]
            pd.vals[lang] = ValueColumn(subj=subj, vals=vals)

        for pred, vmap in self._vfacets.items():
            pd = preds.get(pred)
            if pd is None:
                continue
            for s, fd in vmap.items():
                for k, v in fd.items():
                    pd.vfacets.setdefault(k, {})[int(rank(s))] = v

        build_indexes(preds)
        return Store(uids=uids, schema=self.schema, preds=preds)


def _facet_cols(fwd: EdgeRel, fmap: dict, rank, n: int) -> dict:
    """Edge facets aligned to final forward CSR positions, one column
    per key, sorted by position."""
    pairs = np.array(list(fmap), np.int64).reshape(-1, 2)
    keys = rank(pairs[:, 0]).astype(np.int64) * n + rank(pairs[:, 1])
    fwd_keys = _edge_keys(fwd, n)
    pos = np.searchsorted(fwd_keys, keys)
    hit = pos < len(fwd_keys)
    hit[hit] = fwd_keys[pos[hit]] == keys[hit]
    by_key: dict[str, list[tuple[int, object]]] = {}
    for p, ok, fd in zip(pos.tolist(), hit.tolist(), fmap.values()):
        if not ok:
            continue  # edge was not retained
        for k, v in fd.items():
            by_key.setdefault(k, []).append((p, v))
    out = {}
    for k, pv in by_key.items():
        pv.sort(key=lambda t: t[0])
        out[k] = FacetCol(pos=np.array([p for p, _ in pv], np.int64),
                          vals=np.array([v for _, v in pv], object))
    return out


def build_indexes(preds: dict[str, PredicateData]) -> None:
    """Build inverted token indexes from value columns (reference:
    posting/index.go BuildTokens)."""
    for pred, pd in preds.items():
        ps = pd.schema
        if not ps.index_tokenizers:
            continue
        for tk in ps.index_tokenizers:
            if tk not in ("exact", "hash", "term", "fulltext", "trigram",
                          "geo"):
                continue  # numeric/datetime ranges use sorted columns
            ids: dict[str, int] = {}       # token → id, first seen first
            tid, subj = [], []
            for lang, col in pd.vals.items():
                for s, v in zip(col.subj.tolist(), col.vals):
                    for t in tokens_for(tk, v):
                        tid.append(ids.setdefault(t, len(ids)))
                        subj.append(s)
            pd.index[tk] = _group_postings(list(ids), tid, subj)


def _group_postings(tokens: list, tid: list, subj: list) -> dict:
    """{token: sorted unique int32 ranks} from parallel (token id, rank)
    lists, with one sort for all tokens instead of one per token."""
    if not tokens:
        return {}
    span = max(subj) + 1
    keys = np.unique(np.array(tid, np.int64) * span
                     + np.array(subj, np.int64))
    ranks = (keys % span).astype(np.int32)
    cuts = np.searchsorted(keys // span, np.arange(1, len(tokens)))
    return dict(zip(tokens, np.split(ranks, cuts)))


def _csr_from_pairs(src: np.ndarray, dst: np.ndarray, n: int) -> EdgeRel:
    """Sorted-by-(src, dst), deduped CSR from edge pairs: the native
    builder (`native/csr.cpp`) unless `native.HAVE_NATIVE` is switched
    off; both give the same arrays."""
    if len(src) and n < 2**31 and native.HAVE_NATIVE:
        indptr, indices = native.build_csr(src, dst, n)
        return EdgeRel(indptr=indptr, indices=indices)
    return _csr_from_pairs_np(src, dst, n)


def _csr_from_pairs_np(src: np.ndarray, dst: np.ndarray, n: int) -> EdgeRel:
    """The numpy builder (the reference's `_csr_from_pairs_np`)."""
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if len(src):
        keep = np.concatenate([[True], (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])])
        src, dst = src[keep], dst[keep]
    counts = np.bincount(src, minlength=n).astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    return EdgeRel(indptr=indptr, indices=dst.astype(np.int32))


def _rel_of(r) -> EdgeRel | None:
    if r is None:
        return None
    indptr, indices = ((r.indptr, r.indices) if hasattr(r, "indptr")
                       else r)
    return EdgeRel(np.array(indptr, np.int32), np.array(indices, np.int32))


def _copy_vals(vals, kind: Kind) -> np.ndarray:
    """A value column's copy; geo values are re-read as this package's
    `GeoVal` from their GeoJSON text, and float32vector values copied as
    an object column of 1-D float32 rows."""
    if kind not in (Kind.GEO, Kind.VECTOR):
        return np.array(vals)
    out = np.empty(len(vals), object)
    for i, v in enumerate(vals):
        out[i] = (parse_geo(str(v)) if kind == Kind.GEO
                  else np.array(v, np.float32))
    return out


def store_from_arrays(uids, schema_text: str = "",
                      preds: dict | None = None) -> Store:
    """A port Store from numpy state: the analogue of carrying a model's
    weights across.

    Either pass a reference-shaped object as `uids` (anything with
    `.uids`, `.schema.to_text()` and `.preds[name].{fwd, rev, vals,
    index, efacets, vfacets, rev_pos}` — e.g. a `dgraph_tpu` Store, read
    by duck typing so this package never imports it; its geo values are
    re-read from their GeoJSON text), or plain data:

        uids         sorted int64 uid vocabulary
        schema_text  schema-language text
        preds        {name: {"fwd": (indptr, indices) | None,
                             "rev": (indptr, indices) | None,
                             "vals": {lang: (subj, vals)},
                             "index": {tokenizer: {token: ranks}},
                             "efacets": {key: (positions, values)},
                             "vfacets": {key: {rank: value}},
                             "rev_pos": positions | None}}

    Every array is copied, so the port never aliases the source; facet
    values are copied as they are (float64 weights stay float64)."""
    if hasattr(uids, "preds") and hasattr(uids, "uids"):
        src = uids
        uids = src.uids
        schema_text = src.schema.to_text()
        preds = {name: {"fwd": pd.fwd, "rev": pd.rev,
                        "vals": {lang: (c.subj, c.vals)
                                 for lang, c in pd.vals.items()},
                        "index": pd.index,
                        "efacets": {k: (c.pos, c.vals)
                                    for k, c in pd.efacets.items()},
                        "vfacets": pd.vfacets,
                        "rev_pos": pd.rev_pos}
                 for name, pd in src.preds.items()}
    schema = parse_schema(schema_text)
    out: dict[str, PredicateData] = {}
    for name, spec in (preds or {}).items():
        out[name] = PredicateData(
            schema=schema.get(name),
            fwd=_rel_of(spec.get("fwd")), rev=_rel_of(spec.get("rev")),
            vals={lang: ValueColumn(np.array(s, np.int32),
                                    _copy_vals(v, schema.get(name).kind))
                  for lang, (s, v) in spec.get("vals", {}).items()},
            index={tk: {t: np.array(r, np.int32) for t, r in inv.items()}
                   for tk, inv in spec.get("index", {}).items()},
            efacets={k: FacetCol(np.array(p, np.int64),
                                 np.array(list(v), object))
                     for k, (p, v) in spec.get("efacets", {}).items()},
            vfacets={k: {int(r): v for r, v in m.items()}
                     for k, m in spec.get("vfacets", {}).items()},
            rev_pos=(None if spec.get("rev_pos") is None
                     else np.array(spec["rev_pos"], np.int64)))
    return Store(uids=np.array(uids, np.int64), schema=schema, preds=out)


def store_diff(got: Store, want: Store) -> str | None:
    """The first difference between two stores, tablet for tablet, or
    None: uids, predicate set, forward and reverse CSR, value columns,
    edge and value facets, and token indexes (postings compared as one
    concatenation per tokenizer, so a million tokens cost one pass)."""
    if not np.array_equal(got.uids, want.uids):
        return "uids differ"
    if sorted(got.preds.keys()) != sorted(want.preds.keys()):
        return "predicates differ"
    for p in want.preds.keys():
        a, b = got.preds[p], want.preds[p]
        for side in ("fwd", "rev"):
            ra, rb = getattr(a, side), getattr(b, side)
            if (ra is None) != (rb is None) or (rb is not None and not (
                    np.array_equal(ra.indptr, rb.indptr)
                    and np.array_equal(ra.indices, rb.indices))):
                return f"{p} {side} CSR differs"
        if list(a.vals) != list(b.vals):
            return f"{p} value languages differ"
        for lang, cb in b.vals.items():
            ca = a.vals[lang]
            if not (np.array_equal(ca.subj, cb.subj)
                    and ca.vals.dtype == cb.vals.dtype
                    and _same_items(ca.vals, cb.vals)):
                return f"{p}@{lang} value column differs"
        if list(a.efacets) != list(b.efacets):
            return f"{p} edge facet keys differ"
        for k, fb in b.efacets.items():
            fa = a.efacets[k]
            if not (np.array_equal(fa.pos, fb.pos)
                    and _same_items(fa.vals, fb.vals)):
                return f"{p} edge facet {k} differs"
        if list(a.vfacets) != list(b.vfacets) or not all(
                list(a.vfacets[k]) == list(m)
                and _same_items(list(a.vfacets[k].values()), list(m.values()))
                for k, m in b.vfacets.items()):
            return f"{p} value facets differ"
        if list(a.index) != list(b.index):
            return f"{p} tokenizers differ"
        for tk, ib in b.index.items():
            ia = a.index[tk]
            if ia.keys() != ib.keys():
                return f"{p} {tk} tokens differ"
            pa = [ia[t] for t in ib]
            pb = list(ib.values())
            if pb and not (np.array_equal(np.fromiter(map(len, pa), np.int64),
                                          np.fromiter(map(len, pb), np.int64))
                           and np.array_equal(np.concatenate(pa),
                                              np.concatenate(pb))):
                return f"{p} {tk} postings differ"
    return None


def _same_items(x, y) -> bool:
    """Element-wise equality of two value sequences, vector rows
    (arrays) included."""
    if len(x) != len(y):
        return False
    try:
        return list(x) == list(y)
    except ValueError:          # rows are arrays: == gives an array
        return all(np.array_equal(u, v) for u, v in zip(x, y))
