"""Out-of-core store: fault predicate tablets in on first touch, evict LRU.

Port of `dgraph_tpu/store/outofcore.py`: `LazyPreds`, `open_out_of_core`
and `_pd_nbytes`, with the `outofcore.residency` lock (`utils/locks`).
Besides its `faults`
and `evictions` attributes (the reference's), each fault and LRU
eviction counts in `outofcore_faults_total` / `outofcore_evictions_total`.
Each residency joins the process memory governor as the
`outofcore.resident` cache under the host budget (utils/memgov.py),
beside its own LRU: the governor adds the cross-cache budget, and its
eviction surrenders the LRU-coldest tablet. A clustered Alpha sets
`heal_cb`, which heals a tablet whose segment fails its integrity check
from a group replica.

Reference parity: Badger is an LSM — the reference's data set is NEVER
required to fit in RAM; posting lists page in from disk through the block
cache (SURVEY §2.1), and SURVEY §5 pins the build-side contract: "CSR
block store on host disk …; HBM is a cache, never the source of truth".
This module is the host-RAM leg of that contract: a Store whose
per-predicate tablets live in a versioned checkpoint (store/checkpoint.py)
and materialize on first access, with least-recently-used eviction
holding resident bytes under a budget.

Granularity is the PREDICATE TABLET — the same unit the reference
shards, moves, and snapshots (zero/tablet.go). The uid vocabulary and
schema stay resident (they are the rank dictionary every lookup needs;
their size is O(nodes), not O(edges)).

The returned Store is immutable, like every snapshot: mutations go
through MVCC layers on top, and eviction is invisible to readers —
a re-fault reloads bit-identical arrays from the checkpoint.

SCOPE: the budget governs the read path AND the checkpoint, which runs
through store/stream.py: it faults one tablet at a time and releases it
before the next, so resident bytes never exceed `budget + one tablet`.
A read above the newest fold point folds lazily, one touched tablet at
a time (`mvcc._LazyFoldPreds`); the straggler-absorb and Alter rebuild
legs materialize the whole store. Size hints come from the manifest and
never fault.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from dgraph_tpu_torch.store import checkpoint, vault
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import PredicateData, Store, build_indexes
from dgraph_tpu_torch.utils.metrics import METRICS
from dgraph_tpu_torch.utils import locks


def _pd_nbytes(pd: PredicateData) -> int:
    """Resident-byte estimate for a faulted tablet (arrays dominate;
    python-object columns are counted at pointer width plus a flat
    per-value estimate)."""
    total = 0
    for rel in (pd.fwd, pd.rev):
        if rel is not None:
            total += rel.indptr.nbytes + rel.indices.nbytes
    if pd.rev_pos is not None:
        total += pd.rev_pos.nbytes
    for col in pd.vals.values():
        total += col.subj.nbytes
        total += (col.vals.nbytes if col.vals.dtype != object
                  else len(col.vals) * 64)
    for fcol in pd.efacets.values():
        total += fcol.pos.nbytes + len(fcol.vals) * 64
    for tok_map in pd.index.values():
        for arr in tok_map.values():
            total += arr.nbytes
    return total


class LazyPreds:
    """Mapping of predicate → PredicateData backed by a checkpoint dir.

    First access faults the tablet in (checkpoint.load_predicate + its
    inverted indexes); every access touches LRU order; loads past the
    byte budget evict the least-recently-used tablets (never the one
    being returned). Thread-safe — the serving path reads from many
    request threads."""

    def __init__(self, dirname: str, manifest: dict, schema,
                 budget_bytes: int, root_dir: str | None = None):
        self._dir = dirname
        # the UNRESOLVED open path (versioned root with CURRENT, or the
        # plain dir itself): where a streaming checkpoint writes the
        # next fold of this store (store/stream.py)
        self.root_dir = root_dir if root_dir is not None else dirname
        self._meta = manifest["predicates"]
        self._schema = schema
        self.budget_bytes = budget_bytes
        self._resident: OrderedDict[str, PredicateData] = OrderedDict()
        self._sizes: dict[str, int] = {}
        self._lock = locks.make_rlock("outofcore.residency")
        self._inflight: dict[str, threading.Event] = {}
        self.resident_bytes = 0
        self.peak_resident_bytes = 0  # high-water mark of resident_bytes
        self.faults = 0       # tablets loaded from disk
        self.evictions = 0    # tablets dropped under budget pressure
        self.releases = 0     # tablets dropped by a streaming pass
        # corruption-heal hook (a clustered Alpha): called with the
        # predicate when a fault fails its integrity check; returns a
        # replacement PredicateData pulled from a group replica
        # (TabletSnapshot with the PeerTable's failover) or None to
        # refuse. The healed copy serves in memory; the corrupt segment
        # on disk is rewritten by the next checkpoint or fold.
        self.heal_cb = None
        # join the memory governor: a re-fault reloads bit-identical
        # arrays, so the governor may take the LRU-coldest tablet
        from dgraph_tpu_torch.utils import memgov
        memgov.govern_dict(self, "_resident", "outofcore.resident", "host",
                           lock=self._lock, on_evict=LazyPreds._evicted,
                           nbytes=lambda lp: lp.stats()["resident_bytes"])
        locks.guarded(self, "outofcore.residency")

    def _evicted(self, pred: str, _pd) -> int:
        """Governor eviction of the LRU-coldest tablet, under the lock:
        its accounting, and the bytes freed."""
        freed = self._sizes.pop(pred)
        self.resident_bytes -= freed
        self.evictions += 1
        METRICS.inc("outofcore_evictions_total")
        return freed

    def stats(self) -> dict[str, int]:
        """Residency counters read under the lock — the ONLY way other
        threads (streaming maintenance accounting, debug surfaces) may
        observe them: fault/evict mutate the set pairwise and an
        unlocked peek is exactly the race the sanitizer flags."""
        with self._lock:
            return {"resident_bytes": self.resident_bytes,
                    "peak_resident_bytes": self.peak_resident_bytes,
                    "faults": self.faults,
                    "evictions": self.evictions,
                    "releases": self.releases}

    def size_hints(self) -> dict[str, int]:
        """Per-tablet byte sizes from the manifest, WITHOUT faulting —
        the tablet-size heartbeat (Zero rebalancing input) must not page
        the whole store in. Old checkpoints without recorded sizes
        report resident tablets only."""
        out = {}
        with self._lock:  # fault/evict threads mutate _sizes pairwise
            for pred, meta in self._meta.items():
                nb = meta.get("nbytes")
                if nb is not None:
                    out[pred] = int(nb)
                elif pred in self._sizes:
                    out[pred] = self._sizes[pred]
        return out

    # -- mapping surface the engine uses -------------------------------------
    def get(self, pred, default=None):
        pd = self._fault(pred)
        return pd if pd is not None else default

    def __getitem__(self, pred):
        pd = self._fault(pred)
        if pd is None:
            raise KeyError(pred)
        return pd

    def __contains__(self, pred) -> bool:
        return pred in self._meta

    def __iter__(self):
        return iter(self._meta)

    def __len__(self) -> int:
        return len(self._meta)

    def keys(self):
        return self._meta.keys()

    def items(self):
        """Faults EVERYTHING in — debug/full-materialize paths only.
        Serving code uses get()/[] (one tablet at a time) and
        maintenance passes use store/stream.py::iter_tablets, which
        also releases as it goes."""
        return [(p, self[p]) for p in self._meta]

    def values(self):
        return [self[p] for p in self._meta]

    # -- fault/evict ---------------------------------------------------------
    def is_resident(self, pred: str) -> bool:
        """Whether a tablet is currently faulted in (no LRU touch) —
        the streaming layer uses this to release only tablets IT pulled
        in, leaving the serving path's hot set alone."""
        with self._lock:
            return pred in self._resident

    def release(self, pred: str) -> bool:
        """Explicitly drop one resident tablet (streaming maintenance:
        process a tablet, release it before faulting the next, so a
        whole-store pass never holds more than one tablet above the
        serving working set). Readers holding the PredicateData keep a
        valid immutable reference; the next access re-faults."""
        with self._lock:
            pd = self._resident.pop(pred, None)
            if pd is None:
                return False
            self.resident_bytes -= self._sizes.pop(pred)
            self.releases += 1
            return True

    def _fault(self, pred: str):
        """Resident hit: one cheap lock hop. Cold fault: the disk load +
        index build runs OUTSIDE the lock (a seconds-long cold load must
        not freeze readers of already-resident tablets); concurrent
        requests for the same cold tablet wait on a per-predicate
        in-flight event instead of loading twice."""
        while True:
            with self._lock:
                pd = self._resident.get(pred)
                if pd is not None:
                    self._resident.move_to_end(pred)
                    return pd
                meta = self._meta.get(pred)
                if meta is None:
                    return None
                ev = self._inflight.get(pred)
                if ev is None:
                    ev = self._inflight[pred] = threading.Event()
                    break            # this thread loads
            ev.wait()                # another thread is loading it
            # loop: usually resident now; retry covers an eviction race

        try:
            try:
                pd = checkpoint.load_predicate(self._dir, pred, meta,
                                               self._schema)
                build_indexes({pred: pd})
            except vault.StorageCorruption:
                # a clustered Alpha heals the bad tablet from a group
                # replica before refusing; alone it raises, naming the file
                heal = self.heal_cb
                pd = heal(pred) if heal is not None else None
                if pd is None:
                    raise
                build_indexes({pred: pd})
                METRICS.inc("storage_heals_total")
            size = _pd_nbytes(pd)
            evicted = 0
            with self._lock:
                self.faults += 1
                prev = self._sizes.pop(pred, None)
                if prev is not None:
                    # a concurrent path re-installed this tablet while we
                    # were loading: replacing must not double-charge the
                    # budget — retire the old accounting first
                    # graftlint: allow(split-critical-section): the in-flight-event protocol — the cold load runs outside the lock BY DESIGN (a seconds-long load must not freeze readers), and this reacquisition re-validates _sizes/_resident before installing
                    self._resident.pop(pred, None)
                    self.resident_bytes -= prev
                self._resident[pred] = pd
                self._sizes[pred] = size
                self.resident_bytes += size
                self.peak_resident_bytes = max(self.peak_resident_bytes,
                                               self.resident_bytes)
                if self.resident_bytes > self.budget_bytes:
                    # evict LRU-first, skipping the tablet being returned
                    # (it must survive even when it alone exceeds the
                    # budget). NOTE: no early break on encountering it —
                    # the historical `break` left the budget exceeded
                    # with evictable tablets still resident.
                    for victim in list(self._resident):
                        if self.resident_bytes <= self.budget_bytes:
                            break
                        if victim == pred:
                            continue
                        del self._resident[victim]
                        self.resident_bytes -= self._sizes.pop(victim)
                        self.evictions += 1
                        evicted += 1
            METRICS.inc("outofcore_faults_total")
            if evicted:
                METRICS.inc("outofcore_evictions_total", float(evicted))
            return pd
        finally:
            with self._lock:
                # graftlint: allow(split-critical-section): the in-flight event this same thread INSTALLED in the first acquisition is retired here; waiters re-loop and re-validate residency themselves
                self._inflight.pop(pred, None)
            ev.set()


def open_out_of_core(dirname: str,
                     budget_bytes: int) -> tuple[Store, int]:
    """Open a checkpoint as an out-of-core Store: tablets fault in on
    first touch, LRU-evicted under `budget_bytes` of resident tablet
    data. Returns (store, base_ts) like checkpoint.load."""
    manifest, resolved = checkpoint.read_manifest(dirname)
    uids = checkpoint.load_uids(resolved, manifest)
    schema = parse_schema(manifest["schema"])
    preds = LazyPreds(resolved, manifest, schema, budget_bytes,
                      root_dir=dirname)
    store = Store(uids=np.asarray(uids, np.int64), schema=schema,
                  preds=preds)
    return store, manifest["base_ts"]
