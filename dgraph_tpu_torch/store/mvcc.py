"""MVCC layering over immutable Store snapshots.

Port of `dgraph_tpu/store/mvcc.py`: `Mutation`, `MVCCStore` (apply,
read_view, rollup, absorb_straggler, drop_predicate, rebuild_base,
fold_plan/install_fold, gc), `_LazyFoldPreds` and `_materialize`, with
the reference's `mvcc.store` / `mvcc.lazyview` locks (`utils/locks`).

Reference parity: `posting/mvcc.go` + `posting/list.go` — each posting list
is an immutable layer plus delta layers keyed by commit timestamp;
readers at `read_ts` see base ∪ {deltas with commit_ts ≤ read_ts};
`rollup()` adds a *fold point* (a materialised snapshot at some
commit_ts) without discarding the layers older readers still need;
`gc(min_active_ts)` drops history no open transaction can reach. The
card holds a cache of a snapshot's CSR blocks, never the source of truth.

The fold differs from the reference in how, not in what. The
reference's `_materialize` turns every posting into a Python set entry
and re-adds it through one `StoreBuilder.add_edge`/`add_value` call; here
each tablet folds as numpy arrays: uid pairs become int64 keys
(`subject_rank * n + object_rank`) in the fold's rank space, the layers'
edits (a few per commit) decide which keys and values change, and only
the subjects an edit touched go through Python. A tablet no layer
touched keeps its arrays (remapped when the vocabulary grew). The Store
it gives is the reference's, array for array and in the same dict
orders. Tablets whose values the fast path cannot hold to that rule
(an untyped predicate whose kind the first value decides, `dgraph.type`,
uid-kind values, a tablet an Alter gives a new kind or vector width)
fold through `_materialize_literal`, the reference's code. An Alter
that keeps a tablet's kind (a new index, `@reverse`, list or `@lang`
flag) folds it on the fast path.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.store.schema import Schema
from dgraph_tpu_torch.store.store import (
    TYPE_PRED, EdgeRel, FacetCol, PredicateData, Store, StoreBuilder,
    ValueColumn, _csr_from_pairs, build_indexes)
from dgraph_tpu_torch.store.types import NUMPY_DTYPE, Kind, convert
from dgraph_tpu_torch.utils.metrics import METRICS
from dgraph_tpu_torch.utils import locks

_VIEW_CACHE = 8  # non-fold-point views retained (newest win)


class FoldRaced(ValueError):
    """An externally-materialised fold (store/stream.py streaming
    checkpoint) cannot install: the layer set at or below its fold ts
    changed while it streamed (a straggler absorb or a predicate drop
    raced it). The caller discards the written fold and retries."""


@dataclass
class Mutation:
    """One txn's buffered edits (reference: pb.Mutations / DirectedEdge).

    `*_DEL` entries use object/value None to mean "delete all postings of
    (subject, predicate)" (reference: S P * deletion).
    """

    edge_sets: list = field(default_factory=list)   # (s, pred, o[, facets])
    edge_dels: list = field(default_factory=list)   # (s, pred, o|None)
    val_sets: list = field(default_factory=list)    # (s, pred, v, lang[, facets])
    val_dels: list = field(default_factory=list)    # (s, pred, None, lang)
    # uids to register in the vocabulary even without local postings
    touch_uids: list = field(default_factory=list)

    def all_uids(self) -> set:
        """Every uid this mutation mentions (vocab sync set)."""
        out = set(self.touch_uids)
        for s, _p, o, *_ in self.edge_sets:
            out.add(s)
            out.add(o)
        for s, _p, *_ in self.edge_dels + self.val_sets + self.val_dels:
            out.add(s)
        return out

    def exclude(self, preds) -> "Mutation":
        """Everything EXCEPT the given tablets (straggler absorption
        filters predicates dropped between the commit and a fold)."""
        return Mutation(
            edge_sets=[e for e in self.edge_sets if e[1] not in preds],
            edge_dels=[e for e in self.edge_dels if e[1] not in preds],
            val_sets=[v for v in self.val_sets if v[1] not in preds],
            val_dels=[v for v in self.val_dels if v[1] not in preds],
            touch_uids=sorted(self.all_uids()),
        )

    def restrict(self, preds) -> "Mutation":
        """Subset for the tablets in `preds`, carrying the FULL vocab set."""
        return Mutation(
            edge_sets=[e for e in self.edge_sets if e[1] in preds],
            edge_dels=[e for e in self.edge_dels if e[1] in preds],
            val_sets=[v for v in self.val_sets if v[1] in preds],
            val_dels=[v for v in self.val_dels if v[1] in preds],
            touch_uids=sorted(self.all_uids()),
        )

    def conflict_keys(self, schema=None):
        """Keys the oracle arbitrates on, as deterministic strings
        (reference: posting.addConflictKeys): "<pred>|<subj>" per touched
        list, plus "<pred>|tok|<tokenizer>:<token>" per index token of
        values written to @upsert predicates, so two txns upserting the
        same value collide even under different subjects."""
        keys = set()
        for s, p, *_ in self.edge_sets + self.edge_dels:
            keys.add(f"{p}|{s}")
        for s, p, *_ in self.val_sets + self.val_dels:
            keys.add(f"{p}|{s}")
        if schema is not None:
            from dgraph_tpu_torch.store.tok import tokens_for
            for s, p, v, *_rest in self.val_sets:
                ps = schema.peek(p)
                if not ps or not ps.upsert or v is None:
                    continue
                for t in ps.index_tokenizers:
                    for token in tokens_for(t, v):
                        keys.add(f"{p}|tok|{t}:{token}")
        return keys

    def is_empty(self) -> bool:
        return not (self.edge_sets or self.edge_dels
                    or self.val_sets or self.val_dels or self.touch_uids)


@dataclass
class _Layer:
    commit_ts: int
    mut: Mutation


def _preds_of(layers) -> set:
    return {rec[1] for l in layers
            for rec in (l.mut.edge_sets + l.mut.edge_dels
                        + l.mut.val_sets + l.mut.val_dels)}


def _member(big: np.ndarray, small) -> np.ndarray:
    """`np.isin(big, small)` by binary search into the sorted `small`:
    the fold's sets of edited keys are small beside a tablet."""
    small = np.asarray(small)
    if not len(small) or not len(big):
        return np.zeros(len(big), bool)
    idx = np.searchsorted(small, big)
    return small[np.minimum(idx, len(small) - 1)] == big


def _merge(sorted_a: np.ndarray, sorted_b: np.ndarray) -> np.ndarray:
    """The sorted union of two sorted arrays with no common element."""
    if not len(sorted_b):
        return sorted_a
    return np.insert(sorted_a, np.searchsorted(sorted_a, sorted_b),
                     sorted_b)


def _sorted_member(sorted_big: np.ndarray, small) -> np.ndarray:
    """`np.isin(sorted_big, small)` for a sorted `sorted_big`: one run
    of equal values per element of `small`."""
    small = np.asarray(small)
    mask = np.zeros(len(sorted_big) + 1, np.int64)
    if len(small):
        np.add.at(mask, np.searchsorted(sorted_big, small, "left"), 1)
        np.add.at(mask, np.searchsorted(sorted_big, small, "right"), -1)
    return np.cumsum(mask[:-1]) > 0


def fold_vocab(base: Store, pending) -> np.ndarray:
    """The full-fold uid vocabulary: base vocab ∪ every uid the pending
    layers mention. Shared by the streaming fold writer (store/stream.py)
    and the lazily-folding read view, so every per-tablet
    materialization pins the SAME dense rank space."""
    extra: set[int] = set()
    for layer in pending:
        extra.update(layer.mut.all_uids())
    if not extra:
        return base.uids
    extra = np.array(sorted(extra), np.int64)
    return _merge(base.uids, extra[~_member(extra, base.uids)])


def fold_preds(base: Store, pending) -> list[str]:
    """Stable order over every tablet a fold must visit: base tablets
    plus predicates the deltas introduce."""
    names = set(base.preds.keys())
    names.update(_preds_of(pending))
    return sorted(names)


class _LazyFoldPreds:
    """Predicate mapping of a LAZILY-FOLDING read view over an
    out-of-core base: each tablet materializes (base tablet + pending
    delta layers, vocabulary pinned to the full-fold union) on first
    touch, through `_materialize(only=)`, so a read above the newest
    fold point faults in only the tablets the query touches. Base
    tablets this view itself faulted are released after folding."""

    def __init__(self, base: Store, pending, schema, vocab):
        self._base = base
        self._pending = pending
        self._schema = schema
        self._vocab = vocab
        self._names = set(fold_preds(base, pending))
        self._done: dict[str, object] = {}
        self._lock = locks.make_lock("mvcc.lazyview")
        locks.guarded(self, "mvcc.lazyview")

    def size_hints(self) -> dict:
        """Delegate to the base checkpoint's manifest sizes (the
        tablet-size heartbeat must not fold the view in); pending-layer
        growth is below the hint's own accuracy."""
        hints = getattr(self._base.preds, "size_hints", None)
        return hints() if hints is not None else {}

    def get(self, pred, default=None):
        if pred not in self._names:
            return default
        with self._lock:
            if pred in self._done:
                pd = self._done[pred]
                return pd if pd is not None else default
        pd = self._fold(pred)
        with self._lock:
            # graftlint: allow(split-critical-section): double-checked fold — setdefault re-validates under the reacquisition; when two threads fold the same tablet concurrently the first install wins and both return it
            self._done.setdefault(pred, pd)
            pd = self._done[pred]
        return pd if pd is not None else default

    def _fold(self, pred):
        from dgraph_tpu_torch.store.outofcore import LazyPreds
        lazy = (self._base.preds
                if isinstance(self._base.preds, LazyPreds) else None)
        was_resident = lazy.is_resident(pred) if lazy is not None else True
        folded = _materialize(self._base, self._pending,
                              schema=self._schema, only={pred},
                              vocab=self._vocab)
        if lazy is not None and not was_resident:
            lazy.release(pred)
        METRICS.inc("read_view_lazy_tablets_total")
        return folded.preds.get(pred)

    def __getitem__(self, pred):
        pd = self.get(pred)
        if pd is None:
            raise KeyError(pred)
        return pd

    def __contains__(self, pred) -> bool:
        return pred in self._names

    def __iter__(self):
        return iter(sorted(self._names))

    def __len__(self) -> int:
        return len(self._names)

    def keys(self):
        return sorted(self._names)

    def items(self):
        """Folds EVERY tablet — full-materialize paths only."""
        return [(p, self[p]) for p in sorted(self._names)
                if self.get(p) is not None]

    def values(self):
        return [pd for _p, pd in self.items()]


class MVCCStore:
    """Versioned posting store: fold-point snapshots + delta layers."""

    def __init__(self, base: Store | None = None, base_ts: int = 0):
        self._lock = locks.make_lock("mvcc.store")
        base = base if base is not None else StoreBuilder().finalize()
        # fold points, ascending by ts; the first is the oldest snapshot
        # an open reader can still reach
        self._history: list[tuple[int, Store]] = [(base_ts, base)]
        self.layers: list[_Layer] = []       # all retained, ascending ts
        self._views: dict[tuple, Store] = {}
        # pred -> [drop_ts, ...]: DropAttr history; stragglers landing
        # below a drop must not resurrect the predicate
        self.dropped: dict[str, list[int]] = {}
        # highest uid this store has ever held (a clustered node's
        # /state maxUID)
        self.max_uid_seen = int(base.uids[-1]) if base.n_nodes else 0
        locks.guarded(self, "mvcc.store")

    @property
    def base(self) -> Store:
        with self._lock:
            return self._history[-1][1]

    @property
    def base_ts(self) -> int:
        with self._lock:
            return self._history[-1][0]

    @property
    def schema(self) -> Schema:
        return self.base.schema

    # -- write path ---------------------------------------------------------
    def apply(self, mut: Mutation, commit_ts: int) -> None:
        """Install a committed delta layer, kept sorted by commit_ts."""
        with self._lock:
            if commit_ts <= self._history[-1][0]:
                raise ValueError("commit_ts below newest fold point")
            if any(l.commit_ts == commit_ts for l in self.layers):
                raise ValueError(f"duplicate commit_ts {commit_ts}")
            bisect.insort(self.layers, _Layer(commit_ts, mut),
                          key=lambda l: l.commit_ts)
            self.max_uid_seen = max(self.max_uid_seen,
                                    max(mut.all_uids(), default=0))

    def uid_high(self) -> int:
        """`max_uid_seen` read under the lock (the /state document's
        maxUID while apply threads advance it)."""
        with self._lock:
            return self.max_uid_seen

    def has_applied(self, commit_ts: int) -> bool:
        """Whether a commit_ts is present as a retained delta layer."""
        with self._lock:
            return any(l.commit_ts == commit_ts for l in self.layers)

    def absorb_straggler(self, mut: Mutation, commit_ts: int) -> None:
        """Install a commit whose ts landed at or below an existing fold
        point: every fold snapshot at or above commit_ts is
        re-materialised WITH the record, and the record also joins the
        layer list so readers choosing an older fold see it too."""
        with self._lock:
            if any(l.commit_ts == commit_ts for l in self.layers):
                return
            patched = []
            for fold_ts, store in self._history:
                if fold_ts >= commit_ts:
                    # a predicate dropped between this commit and the
                    # fold must stay dropped
                    gone = {p for p, dts in self.dropped.items()
                            if any(commit_ts < d <= fold_ts for d in dts)}
                    eff = mut.exclude(gone) if gone else mut
                    store = _materialize(store, [_Layer(commit_ts, eff)])
                patched.append((fold_ts, store))
            self._history = patched
            bisect.insort(self.layers, _Layer(commit_ts, mut),
                          key=lambda l: l.commit_ts)
            self.max_uid_seen = max(self.max_uid_seen,
                                    max(mut.all_uids(), default=0))
            self._views.clear()

    # -- read path ----------------------------------------------------------
    def read_view(self, read_ts: int) -> Store:
        """Store snapshot visible at `read_ts` — nearest fold point at or
        below, plus the delta layers in between."""
        with self._lock:
            fold_ts, fold_store = self._fold_at(read_ts)
            pending = [l for l in self.layers
                       if fold_ts < l.commit_ts <= read_ts]
            if not pending:
                return fold_store
            # keyed on the exact layer set: a late out-of-order arrival
            # below a cached ts must not serve a stale view
            key = (fold_ts, tuple(l.commit_ts for l in pending))
            view = self._views.get(key)
            if view is None:
                view = self._make_view(fold_store, pending)
                self._views[key] = view
                while len(self._views) > _VIEW_CACHE:
                    self._views.pop(next(iter(self._views)))
            return view

    @staticmethod
    def _make_view(fold_store: Store, pending) -> Store:
        """In-core: the full fold. Out-of-core: a lazily-folding view
        (only the tablets a query touches materialize)."""
        from dgraph_tpu_torch.store.outofcore import LazyPreds
        if not isinstance(fold_store.preds, LazyPreds):
            return _materialize(fold_store, pending)
        vocab = fold_vocab(fold_store, pending)
        schema = fold_store.schema.clone()
        return Store(uids=vocab, schema=schema,
                     preds=_LazyFoldPreds(fold_store, pending, schema,
                                          vocab))

    def _fold_at(self, ts: int) -> tuple[int, Store]:
        for fold_ts, store in reversed(self._history):
            if fold_ts <= ts:
                return fold_ts, store
        raise ValueError(
            f"read_ts {ts} predates the oldest retained snapshot "
            f"({self._history[0][0]}); raise the gc watermark lag")

    # -- compaction ---------------------------------------------------------
    def rollup(self, upto_ts: int | None = None) -> Store:
        """Create a fold point at `upto_ts` (default: newest layer).
        Older layers/snapshots are RETAINED for open readers until gc()."""
        with self._lock:
            if upto_ts is None:
                upto_ts = (self.layers[-1].commit_ts if self.layers
                           else self._history[-1][0])
            fold_ts, fold_store = self._fold_at(upto_ts)
            pending = [l for l in self.layers
                       if fold_ts < l.commit_ts <= upto_ts]
            if not pending:
                return fold_store
            new_ts = pending[-1].commit_ts
            store = _materialize(fold_store, pending)
            self._history.append((new_ts, store))
            touched = _preds_of(pending)
            # the freshest cached view over a PREFIX of the folded layer
            # set differs from the fold only by the suffix layers: its
            # kernel caches carry for every predicate the suffix left
            # untouched
            pend_ts = tuple(l.commit_ts for l in pending)
            view, vlen = None, -1
            for (f_ts, ts_tup), v in self._views.items():
                if (f_ts == fold_ts and len(ts_tup) > vlen
                        and ts_tup == pend_ts[:len(ts_tup)]):
                    view, vlen = v, len(ts_tup)
            view_touched = (_preds_of(pending[vlen:])
                            if view is not None else set())
        # outside the lock: untouched predicates fold to identical CSR
        # blocks (vocabulary willing), so their ELL blocks, device blocks
        # and programs stay valid
        from dgraph_tpu_torch.engine.batch import carry_kernel_caches
        if view is not None:
            carry_kernel_caches(view, store, view_touched)
        carry_kernel_caches(fold_store, store, touched)
        return store

    def _fold_guard(self, fold_ts: int, upto_ts: int) -> tuple:
        """Fingerprint of what an external fold over (fold_ts, upto_ts]
        absorbed: the pending-layer ts set, the retained layers at or
        below the fold seed, and the drop history (caller holds the
        lock)."""
        return (fold_ts,
                tuple(l.commit_ts for l in self.layers
                      if fold_ts < l.commit_ts <= upto_ts),
                frozenset(l.commit_ts for l in self.layers
                          if l.commit_ts <= fold_ts),
                tuple(sorted((p, tuple(t for t in dts if t <= upto_ts))
                             for p, dts in self.dropped.items()
                             if any(t <= upto_ts for t in dts))))

    def _guard_ok(self, upto_ts: int, guard: tuple) -> bool:
        fold_ts, pend, below, drops = guard
        now_fold, now_pend, now_below, now_drops = \
            self._fold_guard(fold_ts, upto_ts)
        # gc REMOVING already-folded layers is benign; anything NEW at or
        # below upto_ts (a straggler) or a drop is not
        return (now_pend == pend and now_below <= below
                and now_drops == drops)

    def fold_plan(self, upto_ts: int | None = None):
        """(fold_ts, fold_store, pending_layers, new_ts, guard): what a
        fold up to `upto_ts` covers, for a writer that materialises
        outside the store lock (store/stream.py)."""
        with self._lock:
            if upto_ts is None:
                upto_ts = (self.layers[-1].commit_ts if self.layers
                           else self._history[-1][0])
            fold_ts, fold_store = self._fold_at(upto_ts)
            pending = [l for l in self.layers
                       if fold_ts < l.commit_ts <= upto_ts]
            new_ts = pending[-1].commit_ts if pending else fold_ts
            return (fold_ts, fold_store, pending, new_ts,
                    self._fold_guard(fold_ts, new_ts))

    def install_fold(self, new_ts: int, store: Store, guard: tuple) -> None:
        """Install an externally-materialised fold point. Raises
        FoldRaced when the layer/drop state below new_ts changed since
        the plan was taken. Kernel caches carry as in `rollup`."""
        with self._lock:
            if not self._guard_ok(new_ts, guard):
                raise FoldRaced(
                    f"fold at ts {new_ts} raced a straggler/drop; "
                    f"discard and re-plan")
            if any(ts == new_ts for ts, _ in self._history):
                return  # identical content by the MVCC ts contract
            fold_ts = guard[0]
            seed = next((s for t, s in self._history if t == fold_ts),
                        None)
            touched = _preds_of([l for l in self.layers
                                 if fold_ts < l.commit_ts <= new_ts])
            bisect.insort(self._history, (new_ts, store),
                          key=lambda e: e[0])
            self._views.clear()
        if seed is not None:
            from dgraph_tpu_torch.engine.batch import carry_kernel_caches
            carry_kernel_caches(seed, store, touched)

    def history_stores(self) -> list[tuple[int, Store]]:
        with self._lock:
            return list(self._history)

    def pending_layer_count(self) -> int:
        """Delta layers ABOVE the newest fold point — what a rollup
        would absorb (`layers` also holds folded layers retained for open
        readers until gc; a policy on that would spin forever)."""
        with self._lock:
            floor = self._history[-1][0]
            return sum(1 for l in self.layers if l.commit_ts > floor)

    def drop_predicate(self, pred: str, drop_ts: int) -> None:
        """Remove a predicate's data and schema at drop_ts (reference:
        api.Operation{DropAttr}): reads at or above drop_ts see it gone,
        reads below still resolve against the prior folds/layers."""
        with self._lock:
            def strip(st: Store) -> Store:
                schema = st.schema.clone()
                schema.predicates.pop(pred, None)
                return Store(uids=st.uids, schema=schema,
                             preds={p: pd for p, pd in st.preds.items()
                                    if p != pred})

            # folds below the drop are untouched; the drop fold is seed +
            # commits BELOW drop_ts (later commits stay layered, a rebirth
            # stays visible); folds already at/above the drop are patched
            # in place, with the predicate's rebirth commits re-applied
            below = [(t, s) for t, s in self._history if t < drop_ts]
            above = [(t, s) for t, s in self._history if t >= drop_ts]
            new_hist = list(below)
            if below:
                seed_ts, seed = below[-1]
                pend = [l for l in self.layers
                        if seed_ts < l.commit_ts < drop_ts]
                st = _materialize(seed, pend) if pend else seed
                fold_ts = max(drop_ts, seed_ts)
                if not above or above[0][0] > fold_ts:
                    new_hist.append((fold_ts, strip(st)))
            for t, s in above:
                st = strip(s)
                reb = []
                for l in self.layers:
                    if drop_ts < l.commit_ts <= t:
                        r = l.mut.restrict({pred})
                        if (r.edge_sets or r.edge_dels or r.val_sets
                                or r.val_dels):
                            reb.append(_Layer(l.commit_ts, r))
                if reb:
                    st = _materialize(st, reb)
                new_hist.append((t, st))
            self._history = new_hist
            self.dropped.setdefault(pred, []).append(drop_ts)
            self._views.clear()

    def rebuild_base(self, schema: Schema | None = None) -> Store:
        """Re-materialise the newest state under `schema` and fold — the
        index/reverse rebuild behind Alter."""
        with self._lock:
            fold_ts, fold_store = self._history[-1]
            pending = [l for l in self.layers if l.commit_ts > fold_ts]
            new_ts = pending[-1].commit_ts if pending else fold_ts
            store = _materialize(fold_store, pending, schema=schema)
            self._history.append((new_ts, store))
            self._views.clear()
            return store

    def floor_ts(self) -> int:
        """Oldest retained fold point — reads below this would fail."""
        with self._lock:
            return self._history[0][0]

    def install_tablet(self, pred: str, pd) -> None:
        """Swap a whole predicate's data into the newest fold (snapshot
        resync of an owned tablet from a replica — reference: Badger
        Stream snapshot install). Point-in-time reads below the newest
        fold keep their old view; new reads see the resynced tablet.

        The incoming blocks are rank-indexed against the CURRENT
        vocabulary (identical cluster-wide by the vocab-touch broadcast),
        so the state is folded to a snapshot carrying that vocabulary
        before the swap — patching an older fold would mis-index."""
        from dgraph_tpu_torch.store.store import Store, build_indexes
        self.rollup()
        with self._lock:
            fold_ts, store = self._history[-1]
            preds = dict(store.preds)
            preds[pred] = pd
            build_indexes({pred: pd})
            self._history[-1] = (fold_ts, Store(
                uids=store.uids, schema=store.schema, preds=preds))
            self._views.clear()

    def gc(self, min_active_ts: int) -> None:
        """Drop snapshots/layers unreachable by any ts ≥ min_active_ts."""
        with self._lock:
            keep = 0
            for i, (fold_ts, _) in enumerate(self._history):
                if fold_ts <= min_active_ts:
                    keep = i
            self._history = self._history[keep:]
            floor = self._history[0][0]
            self.layers = [l for l in self.layers if l.commit_ts > floor]
            self._views = {k: v for k, v in self._views.items()
                           if k[0] >= floor}


# -- the fold -----------------------------------------------------------------

def _materialize(base: Store, layers: list[_Layer],
                 schema: Schema | None = None, only=None,
                 vocab=None) -> Store:
    """Rebuild a Store from base + deltas: the reference's
    `_materialize`, folded per tablet as numpy arrays (module
    docstring).

    `only` restricts the fold to that predicate set (one tablet per call
    in the streaming fold). `vocab` pins the uid vocabulary, so every
    per-tablet fold uses the rank space of the whole-store fold."""
    b = StoreBuilder(schema=(schema if schema is not None
                             else base.schema.clone()))
    sch = b.schema
    if vocab is not None:
        uids = np.asarray(vocab, np.int64)
        if len(uids) > 1 and not np.all(uids[1:] > uids[:-1]):
            uids = np.unique(uids)
    else:
        uids = fold_vocab(base, layers)
    n = len(uids)
    remap = None
    if not (uids is base.uids or np.array_equal(uids, base.uids)):
        remap = np.searchsorted(uids, base.uids)
    if only is not None:
        base_items = [(p, base.preds.get(p)) for p in sorted(only)]
        base_items = [(p, pd) for p, pd in base_items if pd is not None]
        layers = [l for l in layers
                  if any(rec[1] in only for rec in (
                      l.mut.edge_sets + l.mut.edge_dels
                      + l.mut.val_sets + l.mut.val_dels))]
    else:
        base_items = list(base.preds.items())
    base_pd = dict(base_items)

    # the reference's dict orders: `edges` (base tablets holding edges,
    # then predicates as a star delete or a set first names them) and
    # `vals` ((pred, lang) of the base, then as a set first names them);
    # each edit in commit order, deletes before sets within a layer
    edge_order = [p for p, pd in base_items
                  if pd.fwd is not None and pd.fwd.nnz]
    val_order = [(p, lang) for p, pd in base_items for lang in pd.vals]
    seen_e, seen_v = set(edge_order), set(val_order)
    edge_ops: dict[str, list] = {}
    val_ops: dict[str, list] = {}
    for layer in layers:
        m = layer.mut
        for s, p, o in m.edge_dels:
            if only is not None and p not in only:
                continue
            edge_ops.setdefault(p, []).append((0 if o is not None else 1,
                                               s, o, None))
            if o is None and p not in seen_e:
                seen_e.add(p)
                edge_order.append(p)
        for s, p, o, *f in m.edge_sets:
            if only is not None and p not in only:
                continue
            edge_ops.setdefault(p, []).append((2, s, o, f[0] if f else None))
            if p not in seen_e:
                seen_e.add(p)
                edge_order.append(p)
        for s, p, _v, lang in m.val_dels:
            if only is not None and p not in only:
                continue
            val_ops.setdefault(p, []).append(
                (1 if lang == "*" else 0, s, None, lang, None))
        for s, p, v, lang, *f in m.val_sets:
            if only is not None and p not in only:
                continue
            val_ops.setdefault(p, []).append((2, s, v, lang,
                                              f[0] if f else None))
            if (p, lang) not in seen_v:
                seen_v.add((p, lang))
                val_order.append((p, lang))

    fold = _Fold(base, uids, n, remap, sch)
    preds: dict[str, PredicateData] = {}
    for p in edge_order:
        pd = fold.edges(p, base_pd.get(p), edge_ops.get(p, ()))
        if pd is not None:
            preds[p] = pd
    # value tablets enter in the order of their first non-empty column
    placed = []
    for p in dict.fromkeys(p for p, _lang in val_order):
        ps = sch.peek(p)
        was = base.schema.peek(p) if schema is not None else ps
        if (p == TYPE_PRED or ps is None
                or ps.kind in (Kind.DEFAULT, Kind.UID) or was is None
                or (was.kind, was.vector_dim) != (ps.kind, ps.vector_dim)):
            # the builder decides (or refuses) these per value, as does
            # an Alter that types a tablet anew: the reference's code
            pd = _materialize_literal(base, layers, schema=sch, only={p},
                                      vocab=uids).preds.get(p)
        else:
            pd = fold.values(p, base_pd.get(p), val_ops.get(p, ()),
                             [lang for q, lang in val_order if q == p])
        if pd is None or not pd.vals:
            continue
        if p in preds:
            raise ValueError(f"predicate {p!r} is a uid predicate")
        keys = [i for i, (q, _lang) in enumerate(val_order) if q == p]
        first = min((val_order.index((p, lang)) for lang in pd.vals
                     if (p, lang) in seen_v), default=keys[0])
        placed.append((first, p, pd))
    for _first, p, pd in sorted(placed, key=lambda t: t[0]):
        preds[p] = pd
    return Store(uids=uids, schema=sch, preds=preds)


class _Fold:
    """Per-tablet folds of one `_materialize` call: the new vocabulary
    (`uids`, size `n`), the old→new rank map (`remap`, None when the
    vocabulary did not change) and the builder's schema."""

    def __init__(self, base: Store, uids, n: int, remap, sch: Schema):
        self.base = base
        self.uids = uids
        self.n = n
        self.remap = remap
        self.sch = sch

    # -- helpers --------------------------------------------------------------
    def ranks(self, uid_list) -> np.ndarray:
        """New ranks of uids; -1 where a uid is not in the vocabulary."""
        a = np.asarray(list(uid_list), np.int64)
        if not len(a) or not self.n:
            return np.full(len(a), -1, np.int64)
        r = np.searchsorted(self.uids, a)
        rc = np.minimum(r, self.n - 1)
        return np.where(self.uids[rc] == a, rc, -1)

    def new_rank(self, old):
        return old if self.remap is None else self.remap[old]

    def rel(self, rel: EdgeRel) -> EdgeRel:
        """A CSR in the new rank space (same positions: the remap keeps
        the (subject, object) order)."""
        if self.remap is None:
            return rel
        counts = np.zeros(self.n, np.int64)
        counts[self.remap] = np.diff(rel.indptr)
        indptr = np.zeros(self.n + 1, np.int32)
        np.cumsum(counts, out=indptr[1:])
        return EdgeRel(indptr=indptr,
                       indices=self.remap[rel.indices].astype(np.int32))

    def keys_of(self, rel: EdgeRel) -> np.ndarray:
        """Ascending int64 pair keys, subject_rank * n + object_rank, of a
        base CSR in the new rank space."""
        src = np.repeat(np.arange(len(rel.indptr) - 1, dtype=np.int64),
                        np.diff(rel.indptr).astype(np.int64))
        dst = rel.indices.astype(np.int64)
        if self.remap is not None:
            src, dst = self.remap[src], self.remap[dst]
        return src * self.n + dst

    # -- edge tablets -----------------------------------------------------------
    def edges(self, p: str, pd0, ops) -> PredicateData | None:
        n = self.n
        has_base = pd0 is not None and pd0.fwd is not None and pd0.fwd.nnz
        if not ops and not has_base:
            return None
        K0 = (self.keys_of(pd0.fwd) if has_base and ops
              else np.zeros(0, np.int64))
        last_set: dict[int, int] = {}
        last_del: dict[int, int] = {}
        last_star: dict[int, int] = {}
        last_fset: dict[int, tuple] = {}
        if ops:
            sr = self.ranks(op[1] for op in ops).tolist()
            orr = self.ranks(op[2] if op[2] is not None else -1
                             for op in ops).tolist()
            for seq, ((kind, _s, _o, f), s, o) in enumerate(
                    zip(ops, sr, orr)):
                if kind == 1:
                    last_star[s] = seq
                elif kind == 0:
                    if o >= 0:          # an unknown object has no edge
                        last_del[s * n + o] = seq
                else:
                    k = s * n + o
                    last_set[k] = seq
                    if f:
                        last_fset[k] = (seq, f)
        if not ops:
            final, aff_base = None, None
        else:
            touched = np.array(sorted(set(last_set) | set(last_del)),
                               np.int64)
            aff = _member(K0, touched)
            stars = np.array(sorted(last_star), np.int64)
            if len(stars):
                aff |= _sorted_member(K0 // n, stars)
            aff_base = set(K0[aff].tolist())
            extra = []
            for k in aff_base | set(last_set):
                d = max(last_del.get(k, -1), last_star.get(k // n, -1))
                st = last_set.get(k, -1)
                if st > d or (st < 0 and d < 0 and k in aff_base):
                    extra.append(k)
            final = _merge(K0[~aff], np.array(sorted(extra), np.int64))
            if not len(final):
                return None
        ps = self.sch.get(p)
        if ps.kind == Kind.DEFAULT:
            ps.kind = Kind.UID
        elif ps.kind != Kind.UID:
            raise ValueError(
                f"predicate {p!r} holds {ps.kind} values, not uids")
        if not ops:
            fwd = self.rel(pd0.fwd)
        else:
            counts = np.bincount(final // n, minlength=n)
            indptr = np.zeros(n + 1, np.int32)
            np.cumsum(counts, out=indptr[1:])
            fwd = EdgeRel(indptr=indptr,
                          indices=(final % n).astype(np.int32))
        rev = None
        if ps.reverse:
            if not ops and pd0.rev is not None:
                rev = self.rel(pd0.rev)
            else:
                src = np.repeat(np.arange(n, dtype=np.int32),
                                np.diff(fwd.indptr))
                rev = _csr_from_pairs(fwd.indices, src, n)
        out = PredicateData(schema=ps, fwd=fwd, rev=rev)
        out.efacets = self._edge_facets(
            pd0.efacets if has_base else {}, K0, final, aff_base,
            last_fset, last_del, last_star)
        if not ops and self.remap is None and pd0.rev_pos is not None:
            out.rev_pos = pd0.rev_pos
        build_indexes({p: out})
        return out

    def _edge_facets(self, base_cols: dict, K0, final, aff_base,
                     last_fset, last_del, last_star) -> dict:
        """Facet columns of the folded tablet. A pair's facets are those
        of its last facet-affecting edit (a set with facets, a delete, a
        star delete of its subject; a set without facets keeps them), or
        the base's when no edit affected it. Keys come in the order the
        reference's builder meets them: by the first position holding
        the key, then the key's place in that pair's facet map."""
        n = self.n
        decided = set()
        op_facets = []          # (position, facet map) set by an edit
        if aff_base is not None:
            stars = np.array(sorted(last_star), np.int64)
            cand = (set(last_fset) | set(last_del)
                    | set(K0[_sorted_member(K0 // n, stars)].tolist()
                          if len(stars) else ()))
            for k in cand:
                decided.add(k)
                fs = last_fset.get(k, (-1, None))
                d = max(last_del.get(k, -1), last_star.get(k // n, -1))
                if fs[0] > d:
                    pos = int(np.searchsorted(final, k))
                    if pos < len(final) and final[pos] == k:
                        op_facets.append((pos, fs[1]))
        decided = np.array(sorted(decided), np.int64)
        cols: dict[str, tuple[list, list]] = {}
        first: dict[str, tuple] = {}
        for bi, (name, fc) in enumerate(base_cols.items()):
            if aff_base is None:
                pos, vals = fc.pos, fc.vals
            else:
                pk = K0[fc.pos]
                idx = np.searchsorted(final, pk)
                ok = idx < len(final)
                ok[ok] = final[idx[ok]] == pk[ok]
                if len(decided):
                    ok &= ~_member(pk, decided)
                pos, vals = idx[ok].astype(np.int64), fc.vals[ok]
            if len(pos):
                cols[name] = ([pos], [vals])
                first[name] = (int(pos[0]), bi)
        for pos, fmap in op_facets:
            for j, (name, v) in enumerate(fmap.items()):
                one = np.empty(1, object)
                one[0] = v
                c = cols.setdefault(name, ([], []))
                c[0].append(np.array([pos], np.int64))
                c[1].append(one)
                if name not in first or (pos, j) < first[name]:
                    first[name] = (pos, j)
        out = {}
        for name in sorted(cols, key=lambda k: first[k]):
            ps_, vs_ = cols[name]
            if aff_base is None and len(ps_) == 1:
                out[name] = base_cols[name]
                continue
            pos = np.concatenate(ps_)
            vals = np.concatenate(vs_)
            order = np.argsort(pos, kind="stable")
            out[name] = FacetCol(pos=pos[order], vals=vals[order])
        return out

    # -- value tablets ----------------------------------------------------------
    def values(self, p: str, pd0, ops, langs) -> PredicateData | None:
        """The value tablet `p` after `ops`, over the language keys
        `langs` (the reference's `vals` order for this predicate)."""
        ps = self.sch.get(p)
        kind = ps.kind
        base_cols = pd0.vals if pd0 is not None else {}
        is_list = ps.is_list
        base = self.base
        state: dict[str, dict] = {}      # lang -> {subject uid: values}
        vf_ops: dict[int, dict | None] = {}
        live = [l for l in langs if l in base_cols]

        def base_vals(lang, s):
            col = base_cols.get(lang)
            if col is None:
                return []
            r = base.rank_of([s])[0]
            return col.get(int(r)) if r >= 0 else []

        for kind_, s, v, lang, f in ops:
            if kind_ == 1:
                for l in live:
                    state.setdefault(l, {})[s] = []
                vf_ops[s] = None
            elif kind_ == 0:
                state.setdefault(lang, {})[s] = []
            else:
                if lang not in live:
                    live.append(lang)
                d = state.setdefault(lang, {})
                if is_list:
                    if s not in d:
                        d[s] = base_vals(lang, s)
                    d[s] = d[s] + [v]
                else:
                    d[s] = [v]
                if f:
                    vf_ops[s] = dict(f)

        out = PredicateData(schema=ps)
        for lang in live:
            col = self._value_column(p, ps, kind, base_cols.get(lang),
                                     state.get(lang, {}))
            if col is not None:
                out.vals[lang] = col
        if not out.vals:
            return None
        out.vfacets = self._value_facets(pd0, out, vf_ops)
        if ops or (pd0 is not None and pd0.schema.index_tokenizers
                   != ps.index_tokenizers):       # an Alter's new index
            build_indexes({p: out})
        elif self.remap is None:
            out.index = pd0.index
        else:
            out.index = {tk: {t: self.remap[r].astype(np.int32)
                              for t, r in inv.items()}
                         for tk, inv in pd0.index.items()}
        return out

    def _value_column(self, p, ps, kind, col0, aff: dict):
        """One language column: the base rows of subjects no edit
        touched, and the touched subjects' values converted and deduped
        as the builder does, in subject order."""
        if kind == Kind.VECTOR and ps.vector_dim == 0 and col0 is not None \
                and len(col0.vals):
            ps.vector_dim = int(len(col0.vals[0]))
        if not aff and self.remap is None and col0 is not None \
                and len(col0.subj):
            return col0
        if col0 is not None and len(col0.subj):
            keep = np.ones(len(col0.subj), bool)
            if aff:
                old = self.base.rank_of(list(aff))
                keep = ~_member(col0.subj, np.sort(old[old >= 0]))
            k_subj = self.new_rank(col0.subj[keep].astype(np.int64))
            k_vals = col0.vals[keep]
        else:
            k_subj = np.zeros(0, np.int64)
            k_vals = np.zeros(0, NUMPY_DTYPE[kind])
        n_subj, n_vals = [], []
        touched = sorted(aff)
        for s, r in zip(touched, self.ranks(touched).tolist()):
            seen = set()
            for v in aff[s]:
                v = _to_py(v)
                if kind == Kind.VECTOR:
                    v = convert(v, Kind.VECTOR)
                    if ps.vector_dim == 0:
                        ps.vector_dim = int(len(v))
                    elif len(v) != ps.vector_dim:
                        raise ValueError(
                            f"predicate {p!r}: vector of dim {len(v)} "
                            f"does not match schema dim {ps.vector_dim}")
                cv = convert(v, kind)
                if isinstance(cv, np.datetime64):
                    key = cv.astype("int64").item()
                elif isinstance(cv, np.ndarray):
                    key = cv.tobytes()
                else:
                    key = cv
                if key in seen:
                    continue
                seen.add(key)
                n_subj.append(r)
                n_vals.append(cv)
        if not len(k_subj) and not n_subj:
            return None
        if not n_subj:
            return ValueColumn(subj=k_subj.astype(np.int32), vals=k_vals)
        new_vals = np.empty(len(n_vals), dtype=NUMPY_DTYPE[kind])
        for i, v in enumerate(n_vals):
            new_vals[i] = v
        # touched and kept subjects are disjoint: the touched rows go in
        # before the first kept row of a larger subject
        at = np.searchsorted(k_subj, np.array(n_subj, np.int64))
        return ValueColumn(
            subj=np.insert(k_subj, at, n_subj).astype(np.int32),
            vals=_insert_rows(k_vals, at, new_vals))

    def _value_facets(self, pd0, out: PredicateData, vf_ops: dict) -> dict:
        """Value facets of the folded tablet, keyed and ordered as the
        builder orders them: subjects by their first value scanning the
        columns in order, keys by first appearance."""
        fac: dict[int, dict] = {}
        if pd0 is not None:
            for key, m in pd0.vfacets.items():
                for r_old, v in m.items():
                    u = int(self.base.uids[r_old])
                    if u not in vf_ops:
                        fac.setdefault(u, {})[key] = v
        for u, d in vf_ops.items():
            if d:
                fac[u] = d
        if not fac:
            return {}
        fac_uids = np.array(sorted(fac), np.int64)
        order = [(r, u) for r, u in zip(self.ranks(fac_uids).tolist(),
                                        fac_uids.tolist()) if r >= 0]
        # subjects are met in rank order within each column, columns in
        # order; a subject keeps the place of its first meeting
        scan, met = [], set()
        for col in out.vals.values():
            subj = set(np.unique(col.subj).tolist())
            for r, u in order:
                if u not in met and r in subj:
                    met.add(u)
                    scan.append((r, u))
        vfac: dict[str, dict] = {}
        for r, u in scan:
            for k, v in fac[u].items():
                vfac.setdefault(k, {})[int(r)] = v
        return vfac


def _insert_rows(vals: np.ndarray, at: np.ndarray,
                 rows: np.ndarray) -> np.ndarray:
    """`np.insert` for a value column, object columns included (whose
    elements may be arrays that `np.insert` would broadcast)."""
    if vals.dtype != object:
        return np.insert(vals, at, rows)
    out = np.empty(len(vals) + len(rows), object)
    dst = at + np.arange(len(at))
    keep = np.ones(len(out), bool)
    keep[dst] = False
    out[keep] = vals
    for i, j in enumerate(dst.tolist()):
        out[j] = rows[i]
    return out


def _materialize_literal(base: Store, layers: list[_Layer],
                         schema: Schema | None = None, only=None,
                         vocab=None) -> Store:
    """The reference's `_materialize`, line for line: every posting
    through a Python set and one `StoreBuilder` call. The fold uses it
    for tablets whose values the builder types one by one; the tests
    hold `_materialize` to it."""
    b = StoreBuilder(schema=(schema if schema is not None
                             else base.schema.clone()))
    if vocab is not None:
        b.touch_many(vocab)
    else:
        b.touch_many(base.uids)
        for layer_ in layers:
            b.touch_many(sorted(layer_.mut.all_uids()))
    if only is not None:
        base_items = [(p, base.preds.get(p)) for p in sorted(only)]
        base_items = [(p, pd) for p, pd in base_items if pd is not None]
        layers = [_Layer(l.commit_ts, l.mut.restrict(only))
                  for l in layers]
    else:
        base_items = base.preds.items()

    edges: dict[str, set] = {}
    efacets: dict[str, dict] = {}
    vfacets: dict[str, dict] = {}
    for pred, pd in base_items:
        if pd.fwd is not None and pd.fwd.nnz:
            deg = pd.fwd.indptr[1:] - pd.fwd.indptr[:-1]
            src_r = np.repeat(np.arange(base.n_nodes), deg)
            s_uid = base.uids[src_r]
            o_uid = base.uids[pd.fwd.indices]
            edges[pred] = set(zip(s_uid.tolist(), o_uid.tolist()))
            for key, fc in pd.efacets.items():
                fm = efacets.setdefault(pred, {})
                for pos, v in zip(fc.pos.tolist(), fc.vals):
                    pair = (int(s_uid[pos]), int(o_uid[pos]))
                    fm.setdefault(pair, {})[key] = v
        for key, d in pd.vfacets.items():
            fm = vfacets.setdefault(pred, {})
            for s_rank, v in d.items():
                fm.setdefault(int(base.uids[s_rank]), {})[key] = v
    vals: dict[tuple, dict] = {}
    for pred, pd in base_items:
        for lang, col in pd.vals.items():
            d = vals.setdefault((pred, lang), {})
            for s, v in zip(col.subj, col.vals):
                d.setdefault(int(base.uids[s]), []).append(v)

    for layer in layers:
        m = layer.mut
        for s, p, o in m.edge_dels:
            if o is None:
                edges[p] = {e for e in edges.get(p, set()) if e[0] != s}
                efacets[p] = {pair: f for pair, f in
                              efacets.get(p, {}).items() if pair[0] != s}
            else:
                edges.get(p, set()).discard((s, o))
                efacets.get(p, {}).pop((s, o), None)
        for s, p, o, *f in m.edge_sets:
            edges.setdefault(p, set()).add((s, o))
            if f and f[0]:
                efacets.setdefault(p, {})[(s, o)] = dict(f[0])
        for s, p, _v, lang in m.val_dels:
            if lang == "*":
                for (vp, _vl), d in vals.items():
                    if vp == p:
                        d.pop(s, None)
                vfacets.get(p, {}).pop(s, None)
            else:
                vals.get((p, lang), {}).pop(s, None)
        for s, p, v, lang, *f in m.val_sets:
            ps = b.schema.peek(p)
            if ps is not None and ps.is_list:
                vals.setdefault((p, lang), {}).setdefault(s, []).append(v)
            else:
                vals.setdefault((p, lang), {})[s] = [v]
            if f and f[0]:
                vfacets.setdefault(p, {})[s] = dict(f[0])

    for pred, es in edges.items():
        fm = efacets.get(pred, {})
        for s, o in sorted(es):
            b.add_edge(s, pred, o, facets=fm.get((s, o)))
    for (pred, lang), d in vals.items():
        fm = vfacets.get(pred, {})
        for s, vlist in sorted(d.items()):
            for v in vlist:
                if pred == TYPE_PRED:
                    b.add_type(s, str(v))
                else:
                    b.add_value(s, pred, _to_py(v), lang,
                                facets=fm.get(s))
    return b.finalize()


def _to_py(v):
    """numpy scalar → python for StoreBuilder.add_value re-ingestion."""
    if isinstance(v, np.generic) and not isinstance(v, np.datetime64):
        return v.item()
    return v
