"""Root/filter function evaluation against the Store.

Port of `dgraph_tpu/engine/funcs.py`: `uid`, `has`, `type`, `uid_in`,
`eq`, `le`/`lt`/`ge`/`gt`/`between` (value, count and val-var
comparisons), `anyofterms`/`allofterms`, `anyoftext`/`alloftext`,
`regexp`, `match`, the geo functions `near`/`within`/`contains`, and
`eval_func_universe`, the frontier-restricted form child-level filters
use. Host-side numpy over columnar value arrays and inverted indexes,
producing sorted int32 rank sets. `similar_to` raises until vector
tablets are ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import re

import numpy as np

from dgraph_tpu_torch.engine.ir import FuncNode
from dgraph_tpu_torch.store import geo as G
from dgraph_tpu_torch.store.store import TYPE_PRED, Store
from dgraph_tpu_torch.store.tok import fulltext_tokens, term_tokens
from dgraph_tpu_torch.store.types import Kind, convert

EMPTY = np.zeros(0, np.int32)


def eval_func(store: Store, f: FuncNode, val_env: dict | None = None) -> np.ndarray:
    """Evaluate a function → sorted unique int32 rank array."""
    name = f.name.lower()
    if f.is_count:
        return _count_compare(store, f, name)
    if f.is_val_var:
        return _val_var_compare(f, name, val_env or {})
    if name == "uid":
        ranks = store.rank_of(np.array(f.uids or [0], np.int64))
        return np.unique(ranks[ranks >= 0]).astype(np.int32)
    if name == "has":
        return store.has_ranks(f.attr)
    if name == "type":
        return store.index_lookup(TYPE_PRED, "exact", str(f.args[0]))
    if name == "uid_in":
        return _uid_in(store, f)
    if name == "eq":
        return _eq(store, f)
    if name in ("le", "lt", "ge", "gt", "between"):
        return _compare(store, f, name)
    if name in ("anyofterms", "allofterms"):
        return _terms(store, f, any_=(name == "anyofterms"))
    if name in ("anyoftext", "alloftext"):
        return _text(store, f, any_=(name == "anyoftext"))
    if name == "regexp":
        return _regexp(store, f)
    if name == "match":
        return _match(store, f)
    if name in ("near", "within", "contains"):
        return _geo_func(store, f, name)
    if name == "similar_to":
        raise NotImplementedError(
            "function 'similar_to' is not ported yet (ROADMAP Queue 1 "
            "item 7: store/vec.py)")
    raise ValueError(f"unknown function {f.name!r}")


def _geo_func(store: Store, f: FuncNode, name: str) -> np.ndarray:
    """Geo queries: cell-cover candidates from the geo index (when
    present), exact haversine / point-in-polygon verification after —
    the reference's two-phase shape.
    Without an index the whole value column is verified."""
    pd = store.preds.get(f.attr)
    if pd is None:
        return np.zeros(0, np.int32)

    def candidates(tokens) -> np.ndarray:
        idx = pd.index.get("geo")
        if idx is None or tokens is None:  # no index / cover too big
            parts = [col.has() for col in pd.vals.values()]
            return (np.unique(np.concatenate(parts)).astype(np.int32)
                    if parts else np.zeros(0, np.int32))
        hits = [idx[t] for t in tokens if t in idx]
        if not hits:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(hits)).astype(np.int32)

    def geo_vals(rank: int):
        for col in pd.vals.values():
            for v in col.get(rank):
                if isinstance(v, G.GeoVal):
                    yield v

    def _coord(arg, ctx):
        if (not isinstance(arg, (list, tuple)) or len(arg) < 2
                or not all(isinstance(x, (int, float)) for x in arg[:2])):
            raise ValueError(f"{ctx} needs [longitude, latitude]")
        return float(arg[0]), float(arg[1])

    if name == "near":
        lon, lat = _coord(f.args[0], "near()")
        if not isinstance(f.args[1], (int, float)):
            raise ValueError("near() needs a numeric distance in meters")
        meters = float(f.args[1])
        out = []
        for r in candidates(G.cover_near(lon, lat, meters)).tolist():
            for v in geo_vals(r):
                pt = v.point()
                if pt is not None and \
                        G.haversine_m(lon, lat, *pt) <= meters:
                    out.append(r)
                    break
                rings = v.rings()
                if rings and G.dist_to_polygon_m(lon, lat,
                                                 rings) <= meters:
                    out.append(r)
                    break
        return np.array(sorted(out), np.int32)

    if name == "within":
        arg = f.args[0]
        if not isinstance(arg, (list, tuple)) or not arg:
            raise ValueError("within() needs polygon coordinates "
                             "[[[lon, lat], ...]]")
        try:
            rings = [[_coord(pt, "within() ring position")
                      for pt in ring] for ring in arg]
        except (TypeError, ValueError) as e:
            raise ValueError(f"within() polygon is malformed: {e}")
        if not rings[0] or len(rings[0]) < 4:
            raise ValueError("within() outer ring needs >= 4 positions")
        xs = [x for x, _ in rings[0]]
        ys = [y for _, y in rings[0]]
        # cover_bbox returns None for antimeridian-crossing query rings
        # (naive bbox would cover the wrong side) — candidates() then
        # scans and the exact verify below decides
        toks = G.cover_bbox(min(xs), min(ys), max(xs), max(ys))
        out = []
        for r in candidates(toks).tolist():
            for v in geo_vals(r):
                pt = v.point()
                if pt is not None and G.point_in_polygon(*pt, rings):
                    out.append(r)
                    break
                vrings = v.rings()
                # a stored polygon is within the query area when its
                # whole boundary is: vertices AND edge midpoints are
                # tested, so a concave query edge cutting between two
                # contained vertices is caught (segment-granularity
                # approximation of exact S2 containment)
                if vrings and all(
                        G.point_in_polygon(x, y, rings)
                        for x, y in _ring_probes(vrings[0])):
                    out.append(r)
                    break
        return np.array(sorted(out), np.int32)

    # contains(loc, [lon, lat]): stored POLYGONS containing the point
    lon, lat = _coord(f.args[0], "contains()")
    toks = set(G.point_tokens(lon, lat, prefix="py"))
    out = []
    for r in candidates(toks).tolist():
        for v in geo_vals(r):
            rings = v.rings()
            if rings and G.point_in_polygon(lon, lat, rings):
                out.append(r)
                break
    return np.array(sorted(out), np.int32)


# -- helpers ----------------------------------------------------------------

def _ring_probes(ring):
    """Vertices plus edge midpoints of a polygon ring — the containment
    probe set within() tests against the query area. Midpoints follow
    each edge's SHORTER longitudinal arc (store.geo per-edge rule), so
    an antimeridian-crossing edge probes near ±180, not near 0."""
    xs = G.unwrap_lons([x for x, _ in ring])
    n = len(ring)
    for i in range(n):
        x1, y1 = xs[i], ring[i][1]
        yield ring[i][0], y1
        x2, y2 = xs[(i + 1) % n], ring[(i + 1) % n][1]
        mx = (x1 + x2) / 2.0
        yield ((mx + 180.0) % 360.0) - 180.0, (y1 + y2) / 2.0


def _schema_kind(store: Store, attr: str) -> Kind:
    ps = store.schema.peek(attr)
    kind = ps.kind if ps else Kind.DEFAULT
    return Kind.STRING if kind == Kind.DEFAULT else kind


def _columns(store: Store, f: FuncNode):
    """Value columns to scan: the lang-tagged one if requested, else all."""
    p = store.preds.get(f.attr)
    if not p:
        return []
    if f.lang:
        col = p.vals.get(f.lang)
        return [col] if col is not None else []
    return list(p.vals.values())


def _scan(store: Store, f: FuncNode, predicate_fn) -> np.ndarray:
    """Apply a vectorised predicate over all value columns → rank set."""
    hits = [col.subj[predicate_fn(col.vals)] for col in _columns(store, f)]
    if not hits:
        return EMPTY
    return np.unique(np.concatenate(hits)).astype(np.int32)


def _scan_universe(store: Store, f: FuncNode, predicate_fn,
                   universe: np.ndarray) -> np.ndarray:
    """_scan restricted to a sorted candidate rank set: each column's
    candidate rows are selected by searchsorted (columns are
    subject-sorted) BEFORE the predicate runs, so a child-level filter's
    cost tracks the frontier, not the whole predicate."""
    hits = []
    for col in _columns(store, f):
        if not len(col.subj) or not len(universe):
            continue
        lo = np.searchsorted(col.subj, universe, "left")
        hi = np.searchsorted(col.subj, universe, "right")
        counts = (hi - lo).astype(np.int64)
        total = int(counts.sum())
        if not total:
            continue
        base = np.repeat(np.cumsum(counts) - counts, counts)
        rows = (np.repeat(lo.astype(np.int64), counts)
                + np.arange(total) - base)
        mask = predicate_fn(col.vals[rows])
        if mask.any():
            hits.append(col.subj[rows[np.asarray(mask, bool)]])
    if not hits:
        return EMPTY
    return np.unique(np.concatenate(hits)).astype(np.int32)


def eval_func_universe(store: Store, f: FuncNode,
                       universe: np.ndarray) -> np.ndarray | None:
    """Evaluate a filter function AGAINST a sorted candidate set where
    that is cheaper than materializing the full match set: comparisons,
    non-indexed eq, and has(). Returns the matching subset of `universe`
    (sorted), or None → the caller intersects the full set. Indexed eq
    stays on the full path: its index lookup is already O(tokens)."""
    name = f.name.lower()
    if f.is_count or f.is_val_var:
        return None
    if name in ("le", "lt", "ge", "gt", "between"):
        return _scan_universe(store, f, _cmp_pred(store, f, name),
                              universe)
    if name == "eq":
        kind = _schema_kind(store, f.attr)
        ps = store.schema.peek(f.attr)
        toks = ps.index_tokenizers if ps else ()
        if not f.lang and kind in (Kind.STRING, Kind.DEFAULT) and \
                ("exact" in toks or "hash" in toks):
            return None  # indexed eq: _eq's O(lookup) wins
        targets = [convert(a, kind) for a in f.args]
        if kind == Kind.DATETIME:
            targets = np.array(targets, "datetime64[us]")
        tgt = np.array(targets)
        return _scan_universe(
            store, f,
            lambda vals: np.isin(_cmp_arrays(vals, kind), tgt),
            universe)
    if name == "has" and not f.args:
        # degree / value-presence test per candidate — O(|universe|)
        reverse = f.attr.startswith("~")
        p = store.preds.get(f.attr.lstrip("~"))
        if p is None:
            return EMPTY
        keep = np.zeros(len(universe), bool)
        rel = p.rev if reverse else p.fwd
        if rel is not None:
            keep |= (rel.indptr[universe + 1]
                     - rel.indptr[universe]) > 0
        if not reverse:
            for col in p.vals.values():
                lo = np.searchsorted(col.subj, universe, "left")
                hi = np.searchsorted(col.subj, universe, "right")
                keep |= hi > lo
        return universe[keep].astype(np.int32)
    return None


def _cmp_arrays(vals: np.ndarray, kind: Kind):
    if kind in (Kind.STRING, Kind.DEFAULT, Kind.PASSWORD):
        return vals.astype(str)
    return vals


def _eq(store: Store, f: FuncNode) -> np.ndarray:
    kind = _schema_kind(store, f.attr)
    ps = store.schema.peek(f.attr)
    toks = ps.index_tokenizers if ps else ()
    # index-answerable eq for string-ish kinds; the inverted index merges
    # all language columns, so lang-tagged eq must take the scan path
    if not f.lang and kind in (Kind.STRING, Kind.DEFAULT) and \
            ("exact" in toks or "hash" in toks):
        tk = "exact" if "exact" in toks else "hash"
        hits = [store.index_lookup(f.attr, tk, str(a)) for a in f.args]
        return np.unique(np.concatenate(hits)).astype(np.int32) if hits else EMPTY
    targets = [convert(a, kind) for a in f.args]
    if kind == Kind.DATETIME:
        targets = np.array(targets, "datetime64[us]")
    return _scan(store, f, lambda vals: np.isin(_cmp_arrays(vals, kind),
                                                np.array(targets)))


def _cmp_pred(store: Store, f: FuncNode, op: str):
    """The le/lt/ge/gt/between predicate closure, shared by the
    full-column scan and the universe-restricted path."""
    kind = _schema_kind(store, f.attr)
    args = [convert(a, kind) for a in f.args]

    def pred(vals):
        v = _cmp_arrays(vals, kind)
        a0 = args[0]
        if op == "le":
            return v <= a0
        if op == "lt":
            return v < a0
        if op == "ge":
            return v >= a0
        if op == "gt":
            return v > a0
        return (v >= a0) & (v <= args[1])  # between

    return pred


def _compare(store: Store, f: FuncNode, op: str) -> np.ndarray:
    return _scan(store, f, _cmp_pred(store, f, op))


def _count_compare(store: Store, f: FuncNode, op: str) -> np.ndarray:
    """eq/le/lt/ge/gt/between(count(pred), N) over the CSR degrees."""
    rel = store.rel(f.attr.lstrip("~"), reverse=f.attr.startswith("~"))
    deg = (rel.indptr[1:] - rel.indptr[:-1]).astype(np.int64)
    n = int(f.args[0])
    if op == "eq":
        mask = deg == n
    elif op == "le":
        mask = deg <= n
    elif op == "lt":
        mask = deg < n
    elif op == "ge":
        mask = deg >= n
    elif op == "gt":
        mask = deg > n
    elif op == "between":
        mask = (deg >= n) & (deg <= int(f.args[1]))
    else:
        raise ValueError(f"bad count comparison {op}")
    return np.nonzero(mask)[0].astype(np.int32)


def _val_var_compare(f: FuncNode, op: str, val_env: dict) -> np.ndarray:
    """eq/le/../gt(val(x), N) over a value-variable map (rank → value)."""
    var = val_env.get(f.attr)
    if not var:
        return EMPTY
    ranks = np.fromiter(var.keys(), np.int32, len(var))
    vals = np.array(list(var.values()))
    a0 = vals.dtype.type(f.args[0])
    if op == "eq":
        mask = np.isin(vals, np.array([vals.dtype.type(a) for a in f.args]))
    elif op == "le":
        mask = vals <= a0
    elif op == "lt":
        mask = vals < a0
    elif op == "ge":
        mask = vals >= a0
    elif op == "gt":
        mask = vals > a0
    elif op == "between":
        mask = (vals >= a0) & (vals <= vals.dtype.type(f.args[1]))
    else:
        raise ValueError(f"bad val comparison {op}")
    return np.unique(ranks[mask]).astype(np.int32)


def _uid_in(store: Store, f: FuncNode) -> np.ndarray:
    """uid_in(pred, uid): subjects with an edge pred → uid."""
    targets = store.rank_of(np.array(f.uids, np.int64))
    targets = targets[targets >= 0]
    if not len(targets):
        return EMPTY
    attr = f.attr.lstrip("~")
    reverse = f.attr.startswith("~")
    ps = store.schema.peek(attr)
    if ps and ps.reverse and not reverse:
        rows = [store.rel(attr, reverse=True).row(int(t)) for t in targets]
        return np.unique(np.concatenate(rows)).astype(np.int32)
    # no reverse index: scan the forward CSR (vectorised membership)
    rel = store.rel(attr, reverse=reverse)
    hit_edges = np.isin(rel.indices, targets)
    srcs = np.searchsorted(rel.indptr, np.nonzero(hit_edges)[0], side="right") - 1
    return np.unique(srcs).astype(np.int32)


def _require_index(store: Store, attr: str, tokenizer: str, func: str) -> None:
    """Tokenizer-backed funcs error without the matching @index."""
    ps = store.schema.peek(attr)
    if ps is None or tokenizer not in ps.index_tokenizers:
        raise ValueError(
            f"attribute {attr!r} is not indexed with tokenizer "
            f"{tokenizer!r} (required by {func})")


def _terms(store: Store, f: FuncNode, any_: bool) -> np.ndarray:
    _require_index(store, f.attr, "term",
                   "anyofterms" if any_ else "allofterms")
    toks = term_tokens(" ".join(str(a) for a in f.args))
    return _token_combine(store, f.attr, "term", toks, any_)


def _text(store: Store, f: FuncNode, any_: bool) -> np.ndarray:
    _require_index(store, f.attr, "fulltext",
                   "anyoftext" if any_ else "alloftext")
    toks = fulltext_tokens(" ".join(str(a) for a in f.args))
    return _token_combine(store, f.attr, "fulltext", toks, any_)


def _token_combine(store: Store, attr: str, tokenizer: str, toks,
                   any_: bool) -> np.ndarray:
    if not toks:
        return EMPTY
    lists = [store.index_lookup(attr, tokenizer, t) for t in toks]
    if any_:
        return np.unique(np.concatenate(lists)).astype(np.int32)
    out = lists[0]
    for l in lists[1:]:
        out = np.intersect1d(out, l)
    return out.astype(np.int32)


def _regexp(store: Store, f: FuncNode) -> np.ndarray:
    pat = str(f.args[0])
    flags = 0
    if len(f.args) > 1 and "i" in str(f.args[1]):
        flags |= re.IGNORECASE
    rx = re.compile(pat, flags)
    return _scan(store, f, lambda vals: np.array(
        [bool(rx.search(str(v))) for v in vals], bool))


def _match(store: Store, f: FuncNode) -> np.ndarray:
    """match(attr, term, maxdistance): fuzzy match via Levenshtein bound."""
    term = str(f.args[0]).lower()
    maxd = int(f.args[1]) if len(f.args) > 1 else 2

    def lev_ok(s: str) -> bool:
        s = s.lower()
        if abs(len(s) - len(term)) > maxd:
            return False
        prev = list(range(len(term) + 1))
        for i, c in enumerate(s, 1):
            cur = [i]
            for j, t in enumerate(term, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (c != t)))
            if min(cur) > maxd:
                return False
            prev = cur
        return prev[-1] <= maxd

    return _scan(store, f, lambda vals: np.array(
        [any(lev_ok(w) for w in str(v).split()) for v in vals], bool))
