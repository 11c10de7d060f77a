"""The posting store: uid vocabulary + per-predicate CSR blocks.

Port of `dgraph_tpu/store/store.py` for the batched `@recurse` slice:
`EdgeRel`, `ValueColumn`, `PredicateData`, `Store`, `StoreBuilder`,
`build_indexes` and the CSR builder, over the same dense int32 rank
space:

    uids[int64, N]            sorted global uid vocabulary (rank = position)
    indptr[int32, N+1]        per-predicate row offsets
    indices[int32, nnz]       object ranks, sorted within each row

The host arrays are numpy and equal to the reference's for the same
input; the serving path places what it needs on the device itself
(`ops/bfs.py:device_ell`). CSR construction always takes the numpy
path, which the reference documents as bit-identical to its native
builder. Facets, per-predicate device CSR, vector tablets and the mesh
placements belong to later slices (ROADMAP Queue 1 items 3-4, 7, 10).

`store_from_arrays` builds a port Store from a reference Store's numpy
state (or plain arrays), so both packages can be handed the same data.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.store.schema import PredicateSchema, Schema, parse_schema
from dgraph_tpu_torch.store.tok import tokens_for
from dgraph_tpu_torch.store.types import NUMPY_DTYPE, Kind, convert

TYPE_PRED = "dgraph.type"

_FACETS_LATER = ("facets are not ported yet (ROADMAP Queue 1 item 4: "
                 "store/store.py facet columns)")


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
        lo = np.searchsorted(self.subj, rank, side="left")
        hi = np.searchsorted(self.subj, rank, side="right")
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


@dataclass
class PredicateData:
    schema: PredicateSchema
    fwd: EdgeRel | None = None
    rev: EdgeRel | None = None
    # lang tag → column; "" is the untagged default column
    vals: dict[str, ValueColumn] = field(default_factory=dict)
    # tokenizer → token → sorted int32 rank array
    index: dict[str, dict[str, np.ndarray]] = field(default_factory=dict)


class Store:
    """Immutable posting-store snapshot (host arrays + device cache)."""

    def __init__(self, uids: np.ndarray, schema: Schema,
                 preds: dict[str, PredicateData]):
        if uids.dtype != np.int64 or not np.all(np.diff(uids) > 0):
            raise ValueError("uids must be strictly increasing int64")
        self.uids = uids
        self.schema = schema
        self.preds = preds
        self._empty_rel = EdgeRel(np.zeros(self.n_nodes + 1, np.int32),
                                  np.zeros(0, np.int32))

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

    def index_lookup(self, pred: str, tokenizer: str, token: str) -> np.ndarray:
        """token → sorted rank posting list."""
        p = self.preds.get(pred)
        if not p:
            return np.zeros(0, np.int32)
        return p.index.get(tokenizer, {}).get(token, np.zeros(0, np.int32))


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
        self._known_uids: list[np.ndarray] = []

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
        if facets:
            raise NotImplementedError(_FACETS_LATER)
        self.add_edges(pred, [subj], [obj])

    def add_edges(self, pred: str, subjs, objs) -> None:
        """Vectorised bulk form of add_edge (no facets)."""
        self._uid_pred(pred)
        subjs = np.asarray(subjs, np.int64)
        objs = np.asarray(objs, np.int64)
        self._edges.setdefault(pred, []).append((subjs, objs))
        self._known_uids.extend((subjs, objs))

    def add_value(self, subj: int, pred: str, value, lang: str = "",
                  facets: dict | None = None) -> None:
        if facets:
            raise NotImplementedError(_FACETS_LATER)
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
        self._values.setdefault((pred, lang), []).append((subj, value))
        self._known_uids.append(np.array([subj], np.int64))

    def finalize(self) -> Store:
        uids = (np.unique(np.concatenate(self._known_uids))
                if self._known_uids else np.zeros(0, np.int64))
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

        build_indexes(preds)
        return Store(uids=uids, schema=self.schema, preds=preds)


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
            inv: dict[str, list[int]] = {}
            for lang, col in pd.vals.items():
                for s, v in zip(col.subj, col.vals):
                    for t in tokens_for(tk, v):
                        inv.setdefault(t, []).append(int(s))
            pd.index[tk] = {t: np.unique(np.array(s_list, np.int32))
                            for t, s_list in inv.items()}


def _csr_from_pairs(src: np.ndarray, dst: np.ndarray, n: int) -> EdgeRel:
    """Sorted-by-(src, dst), deduped CSR from edge pairs — the
    reference's numpy builder (`_csr_from_pairs_np`)."""
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


def store_from_arrays(uids, schema_text: str = "",
                      preds: dict | None = None) -> Store:
    """A port Store from numpy state: the analogue of carrying a model's
    weights across.

    Either pass a reference-shaped object as `uids` (anything with
    `.uids`, `.schema.to_text()` and `.preds[name].{fwd, rev, vals,
    index}` — e.g. a `dgraph_tpu` Store, read by duck typing so this
    package never imports it), or plain data:

        uids         sorted int64 uid vocabulary
        schema_text  schema-language text
        preds        {name: {"fwd": (indptr, indices) | None,
                             "rev": (indptr, indices) | None,
                             "vals": {lang: (subj, vals)},
                             "index": {tokenizer: {token: ranks}}}}

    Every array is copied, so the port never aliases the source."""
    if hasattr(uids, "preds") and hasattr(uids, "uids"):
        src = uids
        uids = src.uids
        schema_text = src.schema.to_text()
        preds = {name: {"fwd": pd.fwd, "rev": pd.rev,
                        "vals": {lang: (c.subj, c.vals)
                                 for lang, c in pd.vals.items()},
                        "index": pd.index}
                 for name, pd in src.preds.items()}
    schema = parse_schema(schema_text)
    out: dict[str, PredicateData] = {}
    for name, spec in (preds or {}).items():
        out[name] = PredicateData(
            schema=schema.get(name),
            fwd=_rel_of(spec.get("fwd")), rev=_rel_of(spec.get("rev")),
            vals={lang: ValueColumn(np.array(s, np.int32), np.array(v))
                  for lang, (s, v) in spec.get("vals", {}).items()},
            index={tk: {t: np.array(r, np.int32) for t, r in inv.items()}
                   for tk, inv in spec.get("index", {}).items()})
    return Store(uids=np.array(uids, np.int64), schema=schema, preds=out)
