"""Alpha: the single-node data server (in-process form).

Port of the single-node core of `dgraph_tpu/server/api.py`: `Alpha` and
`Txn` — boot from disk (`Alpha.open`: newest checkpoint + WAL replay),
transactions with first-committer-wins conflicts (`cluster/oracle.py`),
a write-ahead log fsync'd before every in-memory apply (`store/wal.py`),
MVCC read views (`store/mvcc.py`), checkpoints that fold and truncate
the log (`store/checkpoint.py`, `store/stream.py`), and out-of-core
tablets (`store/outofcore.py`). Reads run on `device` (default the
card): `query`/`query_raw` through `engine.Engine`, `query_batch`
through `engine.batch.query_batch`.

Transactions follow the reference's client model: `txn =
alpha.new_txn()`, any number of `txn.query` / `txn.mutate` calls, then
`txn.commit()` (raises `TxnAborted` on conflict) or `txn.discard()`.
`commit_now=True` mutations are single-shot transactions; with
`commit_now=False` the server keeps the txn open, continued by start_ts.

Left to ROADMAP Queue 1 item 9 with the rest of the server: the
cluster (groups, replication, read gates, tablet routing), ACL,
admission and deadlines, cost profiles and priors, the memory governor,
maintenance scheduling, upserts, backup and export. Deliberate
differences: locks are plain `threading` locks, and `query_batch` raises
when a kernel group fails instead of serving its queries one by one
(`engine/batch.py`).
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field

from dgraph_tpu_torch.cluster.oracle import Oracle, TxnAborted
from dgraph_tpu_torch.loader.chunker import NQuad, parse_json, parse_rdf
from dgraph_tpu_torch.loader.xidmap import XidMap
from dgraph_tpu_torch.store.mvcc import MVCCStore, Mutation
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.store.types import Kind, hash_password
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["Alpha", "Txn", "TxnAborted"]

GC_EVERY = 256  # timestamps between oracle/store gc sweeps


class Alpha:
    """Single-process data server: oracle + MVCC store + query engine.

    `device` is where reads run; it defaults to the card and raises
    without one unless the caller names "cpu"."""

    def __init__(self, base: Store | None = None,
                 device_threshold: int = 512, base_ts: int = 0,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.oracle = Oracle()
        self.mvcc = MVCCStore(base=base, base_ts=base_ts)
        self.oracle.bump_ts(base_ts)
        self.xidmap = XidMap(self.oracle)
        self.device_threshold = device_threshold
        self.wal = None  # store.wal.WAL once attached: fsync'd commit log
        self._apply_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._open_txns: dict[int, Txn] = {}
        self._active_reads: dict[int, int] = {}
        self._gc_tick = 0
        if base is not None and base.n_nodes:
            self.oracle.bump_uid(int(base.uids[-1]))

    @classmethod
    def open(cls, p_dir: str, device_threshold: int = 512,
             sync: bool = True, memory_budget: int | None = None,
             device=DEFAULT_DEVICE) -> "Alpha":
        """Boot from a persistence dir: newest checkpoint + WAL replay.
        Every commit that reached the WAL before a crash is recovered.

        `memory_budget` (bytes) opens the checkpoint OUT-OF-CORE:
        predicate tablets fault in from disk on first touch and evict
        LRU under the budget; checkpoints then stream tablet by tablet
        (store/stream.py)."""
        from dgraph_tpu_torch.store import checkpoint

        resolve_device(device)
        base, base_ts = None, 0
        if checkpoint.exists(p_dir):
            if memory_budget is not None:
                from dgraph_tpu_torch.store.outofcore import open_out_of_core
                base, base_ts = open_out_of_core(p_dir, memory_budget)
            else:
                base, base_ts = checkpoint.load(p_dir)
        alpha = cls(base=base, device_threshold=device_threshold,
                    base_ts=base_ts, device=device)
        max_ts, max_uid = alpha.attach_wal(os.path.join(p_dir, "wal.log"),
                                           sync=sync)
        alpha.oracle.bump_ts(max_ts)
        if max_uid:
            alpha.oracle.bump_uid(max_uid)
        return alpha

    def attach_wal(self, wal_path: str, sync: bool = True) -> tuple[int, int]:
        """Replay + arm a WAL on this Alpha. Resolves the commit-quorum
        staging a clustered reference Alpha writes (a pend applies at its
        dec:1 position; an undecided pend was never applied or
        acknowledged and stays invisible), then opens the WAL for
        appends. Returns (max_ts, max_uid) seen, for the caller's oracle
        watermarks."""
        from dgraph_tpu_torch.store.wal import WAL, replay

        base_ts = self.mvcc.base_ts
        max_ts, max_uid = base_ts, 0
        # a record resolved FROM a pend must apply even at or below
        # base_ts: the checkpoint that truncated around it did not hold it
        pends: dict[int, Mutation] = {}
        resolved = []
        for ts, kind, obj in replay(wal_path):
            if kind == "pend":
                pends[ts] = obj
                continue
            if kind == "dec":
                mut = pends.pop(ts, None)
                if obj and mut is not None:
                    resolved.append((ts, "mut", mut, True))
                continue
            resolved.append((ts, kind, obj, False))
        for ts, kind, obj, from_pend in resolved:
            if ts <= base_ts and not from_pend:
                continue  # checkpoint already absorbed it
            if kind == "schema":
                merged = self.mvcc.schema.clone()
                merged.update(parse_schema(obj))
                self.mvcc.rebuild_base(schema=merged)
            elif kind == "drop":
                self.mvcc = MVCCStore()
                self.xidmap = XidMap(self.oracle)
            elif kind == "drop_attr":
                self.mvcc.drop_predicate(obj, ts)
            elif self.mvcc.has_applied(ts):
                continue  # duplicate record
            else:
                try:
                    self.mvcc.apply(obj, ts)
                except ValueError:
                    # decided below the checkpoint fold: fold it in
                    self.mvcc.absorb_straggler(obj, ts)
                for s, _p, o, *_ in obj.edge_sets:
                    max_uid = max(max_uid, s, o)
                for s, _p, *_ in (obj.edge_dels + obj.val_sets
                                  + obj.val_dels):
                    max_uid = max(max_uid, s)
            max_ts = max(max_ts, ts)
        self.wal = WAL(wal_path, sync=sync)
        return max_ts, max_uid

    def checkpoint_to(self, p_dir: str) -> int:
        """Fold all committed state into an on-disk checkpoint and drop
        the WAL records it absorbed. Returns the checkpoint base_ts.

        On an out-of-core base the fold streams tablet-at-a-time
        (store/stream.py) outside the apply lock; only the WAL truncate
        serializes with commits."""
        from dgraph_tpu_torch.store import checkpoint, stream
        lazy = stream.lazy_preds(self.mvcc.base)
        if lazy is not None:
            ts = stream.checkpoint_streaming(
                self.mvcc, p_dir, lazy.budget_bytes)
            with self._apply_lock:
                if self.wal is not None:
                    self.wal.truncate(ts)
            return ts
        with self._apply_lock:
            store = self.mvcc.rollup()
            ts = self.mvcc.base_ts
            # versioned write + atomic CURRENT flip; the WAL is truncated
            # only after the flip succeeded
            checkpoint.save_versioned(store, p_dir, base_ts=ts)
            if self.wal is not None:
                self.wal.truncate(ts)
        return ts

    def shutdown(self, p_dir: str | None = None) -> None:
        """The clean-exit path: a final checkpoint into `p_dir`."""
        if p_dir is not None:
            self.checkpoint_to(p_dir)

    # -- public api surface (api.Dgraph analog) -----------------------------
    def new_txn(self) -> "Txn":
        txn = Txn(self)
        with self._state_lock:
            self._open_txns[txn.start_ts] = txn
        return txn

    def txn(self, start_ts: int) -> "Txn":
        """Continue a server-held open transaction by start_ts."""
        with self._state_lock:
            t = self._open_txns.get(start_ts)
        if t is None:
            raise TxnAborted(f"no open txn at start_ts {start_ts}")
        return t

    @contextlib.contextmanager
    def _reading(self, ts: int | None = None):
        """Track in-flight reads so gc never drops a snapshot under them.
        A sweep between issuing the ts and registering it is caught by
        re-checking the mvcc floor; the read then retries with a fresh
        ts."""
        issued = ts is None
        for attempt in range(8):
            if issued:
                ts = self.oracle.read_only_ts()
            with self._state_lock:
                self._active_reads[ts] = self._active_reads.get(ts, 0) + 1
            if (not issued or attempt == 7
                    or self.mvcc.floor_ts() <= ts):
                break
            with self._state_lock:
                self._active_reads[ts] -= 1
                if not self._active_reads[ts]:
                    del self._active_reads[ts]
        try:
            yield ts
        finally:
            with self._state_lock:
                self._active_reads[ts] -= 1
                if not self._active_reads[ts]:
                    del self._active_reads[ts]

    def _query_view(self, ts: int) -> Store:
        """The MVCC snapshot a query at `ts` executes against."""
        return self.mvcc.read_view(ts)

    def _engine(self, store: Store):
        from dgraph_tpu_torch.engine import Engine
        return Engine(store, device=self.device,
                      device_threshold=self.device_threshold)

    def query(self, dql: str, variables: dict | None = None,
              read_ts: int | None = None) -> dict:
        """Read-only query at a snapshot (reference: Server.Query)."""
        with self._reading(read_ts) as ts:
            out = self._engine(self._query_view(ts)).query(dql, variables)
        self._maybe_gc()
        return out

    def query_raw(self, dql: str, variables: dict | None = None,
                  read_ts: int | None = None) -> bytes:
        """Serving-path query: response BYTES (engine/emit.py)."""
        with self._reading(read_ts) as ts:
            raw = self._engine(self._query_view(ts)).query_bytes(
                dql, variables)
        self._maybe_gc()
        return raw

    def query_batch(self, dqls: list, read_ts: int | None = None) -> list:
        """Serve many queries at one snapshot: compatible groups run as
        lane-packed kernel runs, the rest per query (engine/batch.py).
        Returns one JSON dict per query, in order."""
        from dgraph_tpu_torch.engine.batch import query_batch
        with self._reading(read_ts) as ts:
            out = query_batch(self._query_view(ts), dqls,
                              device=self.device,
                              device_threshold=self.device_threshold)
        self._maybe_gc()
        return out

    def mutate(self, *, set_nquads: str | None = None,
               del_nquads: str | None = None,
               set_json=None, del_json=None,
               commit_now: bool = True,
               start_ts: int | None = None) -> dict:
        """Mutation RPC. With start_ts: continue that open txn. With
        commit_now=False: leave the txn open and return its start_ts."""
        created = not start_ts
        txn = self.txn(start_ts) if start_ts else self.new_txn()
        try:
            uids = txn.mutate(set_nquads=set_nquads, del_nquads=del_nquads,
                              set_json=set_json, del_json=del_json)
            if commit_now:
                txn.commit()
            return {"uids": uids,
                    "txn": {"start_ts": txn.start_ts,
                            "commit_ts": txn.commit_ts}}
        except TxnAborted:
            txn.discard()
            raise
        except Exception:
            # a new txn whose start_ts never reached the client could
            # never be discarded by it and would pin the gc watermark
            if commit_now or created:
                txn.discard()
            raise

    def commit_or_abort(self, start_ts: int, abort: bool = False) -> int:
        """reference: Server.CommitOrAbort. Returns commit_ts (0 on abort)."""
        txn = self.txn(start_ts)
        if abort:
            txn.discard()
            return 0
        return txn.commit()

    def alter(self, schema_text: str) -> None:
        """Schema mutation + index rebuild (reference: Server.Alter). The
        new snapshot is built under the merged schema and swapped in
        atomically."""
        new = parse_schema(schema_text)
        with self._apply_lock:
            ts = self.oracle.read_only_ts()
            merged = self.mvcc.schema.clone()
            merged.update(new)
            if self.wal is not None:
                self.wal.append_schema(schema_text, ts)
            self.mvcc.rebuild_base(schema=merged)

    def drop_attr(self, pred: str) -> None:
        """reference: api.Operation{DropAttr} — delete one predicate's
        data + schema."""
        with self._apply_lock:
            ts = self.oracle.read_only_ts()
            if self.wal is not None:
                self.wal.append_drop_attr(pred, ts)
            self.mvcc.drop_predicate(pred, ts)

    def drop_all(self) -> None:
        """reference: api.Operation{DropAll}."""
        with self._apply_lock:
            ts = self.oracle.read_only_ts()
            if self.wal is not None:
                self.wal.append_drop(ts)
            self.mvcc = MVCCStore()
            self.xidmap = XidMap(self.oracle)
            with self._state_lock:
                self._open_txns.clear()

    # -- commit path (worker/draft.go applyMutations analog) ----------------
    def _commit(self, txn: "Txn") -> int:
        with self._apply_lock:
            commit_ts = self.oracle.commit(
                txn.start_ts, txn.mutation.conflict_keys(self.mvcc.schema))
            # write-ahead: on disk before the in-memory apply, so a crash
            # between the two replays the record
            if self.wal is not None:
                self.wal.append(txn.mutation, commit_ts)
            self.mvcc.apply(txn.mutation, commit_ts)
            return commit_ts

    def _txn_done(self, txn: "Txn") -> None:
        with self._state_lock:
            self._open_txns.pop(txn.start_ts, None)

    # -- maintenance --------------------------------------------------------
    def _maybe_gc(self) -> None:
        with self._state_lock:
            self._gc_tick += 1
            if self._gc_tick % GC_EVERY:
                return
            reads_floor = min(self._active_reads, default=None)
        floor = self.oracle.gc()
        if reads_floor is not None:
            floor = min(floor, reads_floor)
        self.mvcc.gc(floor)
        # superseded on-disk ckpt dirs whose last referencing fold the gc
        # above just dropped are reclaimable now
        from dgraph_tpu_torch.store import stream
        lazy = stream.lazy_preds(self.mvcc.base)
        if lazy is not None:
            stream.gc_superseded(lazy.root_dir, self.mvcc)


@dataclass
class Txn:
    """Transaction bookkeeping (reference: dgo txn / edgraph txn context):
    buffered mutations, blank-node uid map, commit state."""

    alpha: Alpha
    start_ts: int = 0
    commit_ts: int = 0
    mutation: Mutation = field(default_factory=Mutation)
    _blank: dict[str, int] = field(default_factory=dict)
    _done: bool = False

    def __post_init__(self):
        self.start_ts = self.alpha.oracle.read_ts()

    # -- reads --------------------------------------------------------------
    def query(self, dql: str, variables: dict | None = None) -> dict:
        if self._done:
            raise TxnAborted("txn finished")
        return self.alpha.query(dql, variables, read_ts=self.start_ts)

    # -- writes -------------------------------------------------------------
    def mutate(self, *, set_nquads: str | None = None,
               del_nquads: str | None = None,
               set_json=None, del_json=None) -> dict:
        """Buffer mutations; returns blank-node → uid assignments."""
        if self._done:
            raise TxnAborted("txn finished")
        sets: list[NQuad] = []
        dels: list[NQuad] = []
        if set_nquads:
            sets += parse_rdf(set_nquads)
        if set_json is not None:
            sets += parse_json(set_json)
        if del_nquads:
            dels += parse_rdf(del_nquads)
        if del_json is not None:
            dels += parse_json(del_json)
        for nq in sets:
            self._apply_nquad(nq, delete=False)
        for nq in dels:
            self._apply_nquad(nq, delete=True)
        return {b: f"0x{u:x}" for b, u in self._blank.items()}

    def _resolve(self, ref: str) -> int:
        if ref.startswith("_:"):
            uid = self._blank.get(ref)
            if uid is None:
                uid = self.alpha.xidmap.resolve(ref + f"@{self.start_ts}")
                self._blank[ref] = uid
            return uid
        return self.alpha.xidmap.resolve(ref)

    def _apply_nquad(self, nq: NQuad, delete: bool) -> None:
        s = self._resolve(nq.subject)
        m = self.mutation
        schema = self.alpha.mvcc.schema
        if nq.is_star:
            if not delete:
                raise ValueError('object "*" only valid in delete')
            ps = schema.peek(nq.predicate)
            if ps is not None and ps.kind == Kind.UID:
                m.edge_dels.append((s, nq.predicate, None))
            else:
                m.val_dels.append((s, nq.predicate, None, "*"))
        elif nq.object_id is not None:
            o = self._resolve(nq.object_id)
            if delete:
                m.edge_dels.append((s, nq.predicate, o))
            else:
                m.edge_sets.append((s, nq.predicate, o, nq.facets))
        else:
            if delete:
                m.val_dels.append((s, nq.predicate, None, nq.lang))
            else:
                value = nq.object_value
                ps = schema.peek(nq.predicate)
                if ps is not None and ps.kind == Kind.PASSWORD:
                    # hashed ONCE at ingestion: the WAL carries the hash,
                    # so replay is deterministic and plaintext never
                    # reaches disk
                    value = hash_password(str(value))
                elif ps is not None and ps.kind == Kind.GEO:
                    # validated and canonicalized at ingestion, so a
                    # malformed literal fails the mutation
                    from dgraph_tpu_torch.store.geo import parse_geo
                    value = parse_geo(value)
                m.val_sets.append((s, nq.predicate, value, nq.lang,
                                   nq.facets))

    # -- outcome ------------------------------------------------------------
    def commit(self) -> int:
        if self._done:
            raise TxnAborted("txn finished")
        self._done = True
        self.alpha._txn_done(self)
        if self.mutation.is_empty():
            self.alpha.oracle.abort(self.start_ts)
            return 0
        self.commit_ts = self.alpha._commit(self)
        return self.commit_ts

    def discard(self) -> None:
        if not self._done:
            self._done = True
            self.alpha._txn_done(self)
            self.alpha.oracle.abort(self.start_ts)
