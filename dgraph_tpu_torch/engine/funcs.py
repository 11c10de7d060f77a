"""Root function evaluation against the Store.

Port of `dgraph_tpu/engine/funcs.py` for the root functions the batched
`@recurse` slice serves: `uid(...)` and `eq(...)` (index lookup on an
`exact`/`hash` predicate, column scan otherwise). The other functions
raise until the per-query engine is ported (ROADMAP Queue 1 item 4).
Host-side numpy, producing sorted int32 rank sets.
"""

from __future__ import annotations

import numpy as np

from dgraph_tpu_torch.engine.ir import FuncNode
from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.store.types import Kind, convert

EMPTY = np.zeros(0, np.int32)


def eval_func(store: Store, f: FuncNode, val_env: dict | None = None) -> np.ndarray:
    """Evaluate a function → sorted unique int32 rank array."""
    name = f.name.lower()
    if not (f.is_count or f.is_val_var):
        if name == "uid":
            ranks = store.rank_of(np.array(f.uids or [0], np.int64))
            return np.unique(ranks[ranks >= 0]).astype(np.int32)
        if name == "eq":
            return _eq(store, f)
    raise NotImplementedError(
        f"root function {f.name!r} is not ported yet (ROADMAP Queue 1 "
        f"item 4: engine/funcs.py)")


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
