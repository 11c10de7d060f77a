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

Every public entry point runs inside the request shell `_request`: a
budget (`deadline_ms`, else `default_deadline_ms`) installed as the
thread's ambient `utils/deadline.RequestContext`, which the engine's hot
loops checkpoint against (a retryable `DeadlineExceeded` or `Cancelled`,
raised through `with`/`finally` blocks that release every read
registration); a failed serve counts in `query_errors_total{lane=}`.
The checkpoints read the host clock, so a budget bounds the host loop;
device work already queued when it expires runs to its end. Upserts
(`upsert`, `upsert_json`, `dql/upsert.py`) run their query through the
engine on `device` at the txn's snapshot; `export_to`,
`maintenance_rollup` and `attach_maintenance` (`store/maintenance.py`)
are the operator's paths, `server/backup.py` its backups.

Transactions follow the reference's client model: `txn =
alpha.new_txn()`, any number of `txn.query` / `txn.mutate` calls, then
`txn.commit()` (raises `TxnAborted` on conflict) or `txn.discard()`.
`commit_now=True` mutations are single-shot transactions; with
`commit_now=False` the server keeps the txn open, continued by start_ts.

The memory governor and the cost model (utils/memgov.py,
costprofile.py, costprior.py): the shell opens the request's cost record
(`costprofile.profile(lane)`) and, with the priors on
(`costprior.enabled`, the one switch), predicts a query's cost before
the serve and learns from it after; `query_batch` launches its kernel
groups longest-predicted first. `Alpha.open` merges the
`costprofiles.json` and `costpriors.json` the last run saved beside its
checkpoint (a corrupt one is counted and skipped) and refits the priors
without overwriting them; `checkpoint_to` and `shutdown` save them.
`Alpha.status()` reports the governor's budgets, each cache's resident
bytes and evictions, the allocation failures and the degraded shapes,
with the priors' summary. The reference's adapted-tablet cache
(`api.tablet`) comes with the cluster that fills it (item 9e).

The front end (server/http.py) serves an Alpha over HTTP. Its two
guards live here: `attach_admission` arms admission control
(server/admission.py), whose token the shell takes with the request's
predicted cost, and `acl` (server/acl.AclManager) hides the predicates
an `acl_user` may not read (`_query_view`) and refuses writes to those
it may not write. A shed (`ServerOverloaded`), a client's cancel and an
ACL refusal are not failed serves and stay out of `query_errors_total`.

Left to ROADMAP Queue 1: the gRPC worker and the cluster (groups,
replication, read gates, tablet routing; 9e); the flight recorder and
the lock-order sanitizer (9f). Deliberate differences: locks are plain
`threading` locks, and no kernel group is served query by query after a
failure: any failure of a group, an allocation failure its
evict-and-retry did not absorb among them, raises out of `query_batch`
(`engine/batch.py`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

from dgraph_tpu_torch.cluster.oracle import Oracle, TxnAborted
from dgraph_tpu_torch.loader.chunker import NQuad, parse_json, parse_rdf
from dgraph_tpu_torch.loader.xidmap import XidMap
from dgraph_tpu_torch.server.admission import ServerOverloaded
from dgraph_tpu_torch.store.mvcc import MVCCStore, Mutation
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.store.types import Kind, hash_password
from dgraph_tpu_torch.utils import costprior, costprofile, memgov
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dgraph_tpu_torch.utils.metrics import METRICS

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
        # store/maintenance.MaintenanceScheduler | None: background
        # rollup/checkpoint/backup/export jobs (attach_maintenance)
        self.maintenance = None
        # budget of requests that bring none of their own (0 = unbounded)
        self.default_deadline_ms = 0.0
        # server/admission.AdmissionController | None: per-lane tokens, a
        # bounded wait queue and shedding (attach_admission)
        self.admission = None
        self.acl = None  # server/acl.AclManager | None (enforcement on)
        # slow-query log threshold of the HTTP front end, ms (0 = off)
        self.slow_query_ms = 0.0
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
        # cost-profile continuity: merge the aggregate the last run saved
        # beside the checkpoint (the digest merge is exact)
        costprofile.load(os.path.join(p_dir, "costprofiles.json"))
        # merge the saved priors, then fill in the shapes the digests
        # know and the model does not (no overwrite: the merged
        # incremental refinements stay)
        costprior.load(os.path.join(p_dir, "costpriors.json"))
        costprior.refit(overwrite=False)
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

    def checkpoint_to(self, p_dir: str, pace=None) -> int:
        """Fold all committed state into an on-disk checkpoint and drop
        the WAL records it absorbed. Returns the checkpoint base_ts.

        On an out-of-core base the fold streams tablet-at-a-time
        (store/stream.py) outside the apply lock, calling `pace` between
        tablets; only the WAL truncate serializes with commits."""
        from dgraph_tpu_torch.store import checkpoint, stream
        lazy = stream.lazy_preds(self.mvcc.base)
        if lazy is not None:
            ts = stream.checkpoint_streaming(
                self.mvcc, p_dir, lazy.budget_bytes, pace=pace,
                job="checkpoint")
            with self._apply_lock:
                if self.wal is not None:
                    self.wal.truncate(ts)
            self._save_costprofiles(p_dir)
            return ts
        with self._apply_lock:
            store = self.mvcc.rollup()
            ts = self.mvcc.base_ts
            # versioned write + atomic CURRENT flip; the WAL is truncated
            # only after the flip succeeded
            checkpoint.save_versioned(store, p_dir, base_ts=ts)
            if self.wal is not None:
                self.wal.truncate(ts)
        self._save_costprofiles(p_dir)
        return ts

    @staticmethod
    def _save_costprofiles(p_dir: str) -> None:
        """Save the cost-profile aggregate and the priors beside the
        checkpoint (best effort: cost history is telemetry, never worth
        failing a checkpoint over)."""
        with contextlib.suppress(OSError):
            costprofile.save(os.path.join(p_dir, "costprofiles.json"))
        with contextlib.suppress(OSError):
            costprior.save(os.path.join(p_dir, "costpriors.json"))

    def status(self) -> dict:
        """The memory governor's document (budgets and watermarks, each
        cache's resident bytes and evictions, allocation failures and
        degraded shapes) with the cost priors' summary."""
        out = memgov.GOVERNOR.status()
        out["cost_priors"] = {"enabled": costprior.enabled(),
                              **costprior.status()}
        return out

    def maintenance_rollup(self, p_dir: str | None = None,
                           pace=None) -> int:
        """Fold pending delta layers into a new fold point — the
        background rollup job. In-core: the in-memory fold. Out-of-core:
        the fold is STREAMED to a new ckpt dir under `p_dir` (default:
        the dir the base was opened from) and reopened lazily, so the
        budget holds. Returns the new fold ts."""
        from dgraph_tpu_torch.store import stream
        lazy = stream.lazy_preds(self.mvcc.base)
        if lazy is None:
            self.mvcc.rollup()
            return self.mvcc.base_ts
        root = p_dir if p_dir is not None else lazy.root_dir
        return stream.checkpoint_streaming(
            self.mvcc, root, lazy.budget_bytes, pace=pace, job="rollup")

    def export_to(self, out_path: str, format: str = "rdf",
                  pace=None) -> int:
        """Dump committed state as RDF N-Quads or JSON
        (server/export.py). Pending delta layers are folded first;
        an out-of-core base streams tablet-at-a-time. Returns the
        statement (RDF) or node (JSON) count."""
        from dgraph_tpu_torch.server.export import export_json, export_rdf
        if self.mvcc.layers:
            self.maintenance_rollup(pace=pace)
        store = self.mvcc.base
        with open(out_path, "w") as f:
            n = (export_json if format == "json" else export_rdf)(
                store, f, pace=pace)
        return n

    def attach_maintenance(self, p_dir: str, *, rollup_after: int = 0,
                           checkpoint_every_s: float = 0.0,
                           pacing_ms: float = 0.0):
        """Start the background maintenance scheduler on this Alpha
        (store/maintenance.py): rollup-when-deep, periodic checkpoint,
        requested backup/export — paced and pausable."""
        from dgraph_tpu_torch.store.maintenance import MaintenanceScheduler
        self.maintenance = MaintenanceScheduler(
            self, p_dir, rollup_after=rollup_after,
            checkpoint_every_s=checkpoint_every_s,
            pacing_ms=pacing_ms).start()
        return self.maintenance

    def attach_admission(self, max_inflight: int, queue_depth: int,
                         default_deadline_ms: float = 0.0):
        """Arm admission control on this Alpha (server/admission.py):
        per-lane token limits, a bounded FIFO wait queue, and shedding
        with a retryable `ServerOverloaded`. `default_deadline_ms`
        budgets requests that bring none of their own."""
        from dgraph_tpu_torch.server.admission import AdmissionController
        self.admission = AdmissionController(max_inflight, queue_depth)
        self.default_deadline_ms = float(default_deadline_ms)
        return self.admission

    @staticmethod
    def _predict(lane: str, query_text: str) -> tuple[float, str]:
        """(predicted µs, source) of a request. A prediction of 0 µs or
        less is no prediction (a fit over unlike shapes clamps there, as
        `engine/batch.py:plan_cost_us` reads it): the lane's observed-cost
        EMA stands in, else the lane seed, so admission never sees a
        request as free."""
        predicted, source = costprior.predict(lane, text=query_text)
        if predicted <= 0:
            ema = costprior.lane_ema_us(lane)
            predicted = ema if ema is not None and ema > 0 \
                else costprior.LANE_SEED_US
            source = "fallback"
        return predicted, source

    @contextlib.contextmanager
    def _request(self, lane: str, deadline_ms: float | None,
                 query_text: str | None = None):
        """Request-lifecycle shell every public entry point runs inside:
        the budget (explicit `deadline_ms`, else `default_deadline_ms`)
        as the thread's ambient context (utils/deadline.py), which the
        engine's hot loops checkpoint against, the request's cost record
        (`costprofile.profile`, classified at close), and, with admission
        attached, a `lane` token held for the duration. With cost priors
        on and a `query_text`, the cost is predicted before admission
        (shape memo → per-shape prior, lane EMA fallback), rides the
        admission decision, and the observed cost is learned after the
        serve; a shed keeps its prediction in the cost record. A nested
        call (a txn read inside a request) reuses the enclosing context,
        record and token: the OUTER budget governs, and a full lane never
        deadlocks against its own request. Every failed serve but a shed,
        a client's cancel and an ACL refusal counts in
        `query_errors_total{lane=}`."""
        outer = dl.current()
        if outer is not None:
            # a nested leg on the outer record: the leg's boundary is not
            # billed as a launch gap
            with costprofile.launch_frame():
                yield outer
            return
        if deadline_ms is None and self.default_deadline_ms:
            deadline_ms = self.default_deadline_ms
        ctx = dl.RequestContext(deadline_ms)
        with dl.activate(ctx), costprofile.profile(lane):
            predicted = source = None
            priors_on = costprior.enabled()
            if priors_on and query_text is not None:
                predicted, source = self._predict(lane, query_text)
            t0 = time.perf_counter()
            completed = False
            try:
                if self.admission is not None:
                    with self.admission.admit(lane, ctx, cost_us=predicted):
                        # the budget may have died while queued
                        ctx.check("admission")
                        yield ctx
                else:
                    yield ctx
                completed = True
            except (ServerOverloaded, dl.Cancelled, PermissionError):
                # not an error-budget burn: a shed is the shed rate's
                # event, a cancel the client's, a refusal the caller's
                raise
            except Exception:
                METRICS.inc("query_errors_total", lane=lane)
                raise
            finally:
                if predicted is not None:
                    costprofile.note("predicted_us", int(predicted))
                if completed and priors_on and query_text is not None:
                    rec = costprofile.active()
                    costprior.learn(
                        lane, query_text,
                        rec.shape_key() if rec is not None else None,
                        (time.perf_counter() - t0) * 1e6,
                        predicted_us=predicted, source=source)

    def shutdown(self, p_dir: str | None = None) -> None:
        """The clean-exit path: drain maintenance (finish the in-flight
        and requested jobs), then a final checkpoint into `p_dir`."""
        if self.maintenance is not None:
            self.maintenance.stop(drain=True)
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

    def _query_view(self, ts: int, acl_user: str | None = None) -> Store:
        """The store a query at `ts` executes against: the MVCC snapshot,
        restricted to what `acl_user` may read when ACL is on."""
        store = self.mvcc.read_view(ts)
        if self.acl is not None and acl_user is not None:
            store = self.acl.readable_view(acl_user, store)
        return store

    def _engine(self, store: Store):
        from dgraph_tpu_torch.engine import Engine
        return Engine(store, device=self.device,
                      device_threshold=self.device_threshold)

    def query(self, dql: str, variables: dict | None = None,
              read_ts: int | None = None,
              acl_user: str | None = None,
              deadline_ms: float | None = None) -> dict:
        """Read-only query at a snapshot (reference: Server.Query). With
        ACL on and an `acl_user`, unreadable predicates are invisible.
        `deadline_ms` bounds the request: the engine's loops checkpoint
        against it and raise a retryable `DeadlineExceeded` within one
        level / BFS iteration of the budget."""
        with self._request("read", deadline_ms, query_text=dql):
            with self._reading(read_ts) as ts:
                out = self._engine(self._query_view(ts, acl_user)).query(
                    dql, variables)
        self._maybe_gc()
        return out

    def query_raw(self, dql: str, variables: dict | None = None,
                  read_ts: int | None = None,
                  acl_user: str | None = None,
                  deadline_ms: float | None = None) -> bytes:
        """Serving-path query: response BYTES (engine/emit.py)."""
        with self._request("read", deadline_ms, query_text=dql):
            with self._reading(read_ts) as ts:
                raw = self._engine(
                    self._query_view(ts, acl_user)).query_bytes(
                        dql, variables)
        self._maybe_gc()
        return raw

    def query_batch(self, dqls: list, read_ts: int | None = None,
                    acl_user: str | None = None,
                    deadline_ms: float | None = None) -> list:
        """Serve many queries at one snapshot: compatible groups run as
        lane-packed kernel runs, longest-predicted first when the cost
        priors are on, the rest per query (engine/batch.py).
        Returns one JSON dict per query, in order. A dead budget fails
        the whole batch; so does any failure of a kernel group, an
        allocation failure its evict-and-retry did not absorb among
        them."""
        from dgraph_tpu_torch.engine.batch import query_batch
        # the batch's prior key is the joined texts: one combined shape,
        # so a repeated batch hits the same prior
        with self._request("read", deadline_ms,
                           query_text="\x1e".join(dqls)):
            with self._reading(read_ts) as ts:
                out = query_batch(self._query_view(ts, acl_user), dqls,
                                  device=self.device,
                                  device_threshold=self.device_threshold)
        self._maybe_gc()
        return out

    def mutate(self, *, set_nquads: str | None = None,
               del_nquads: str | None = None,
               set_json=None, del_json=None,
               commit_now: bool = True,
               start_ts: int | None = None,
               acl_user: str | None = None,
               deadline_ms: float | None = None) -> dict:
        """Mutation RPC. With start_ts: continue that open txn. With
        commit_now=False: leave the txn open and return its start_ts.
        With ACL on and an `acl_user`, every predicate the txn touches
        must be writable by the user, or the whole txn is discarded. The
        deadline stops the request only BEFORE the commit's WAL append
        (`_commit`), never between the append and the apply."""
        with self._request("mutate", deadline_ms):
            return self._mutate(set_nquads=set_nquads,
                                del_nquads=del_nquads, set_json=set_json,
                                del_json=del_json, commit_now=commit_now,
                                start_ts=start_ts, acl_user=acl_user)

    def _mutate(self, *, set_nquads=None, del_nquads=None, set_json=None,
                del_json=None, commit_now=True, start_ts=None,
                acl_user=None) -> dict:
        created = not start_ts
        txn = self.txn(start_ts) if start_ts else self.new_txn()
        try:
            uids = txn.mutate(set_nquads=set_nquads, del_nquads=del_nquads,
                              set_json=set_json, del_json=del_json)
            self._check_txn_acl(txn, acl_user)
            if commit_now:
                txn.commit()
            return {"uids": uids,
                    "txn": {"start_ts": txn.start_ts,
                            "commit_ts": txn.commit_ts}}
        except TxnAborted:
            txn.discard()
            raise
        except PermissionError:
            # an ACL refusal leaves forbidden edits in the buffer: the
            # whole txn dies, continued or not
            txn.discard()
            raise
        except Exception:
            # a new txn whose start_ts never reached the client could
            # never be discarded by it and would pin the gc watermark
            if commit_now or created:
                txn.discard()
            raise

    # -- upserts (edgraph doQueryInUpsert analog) -----------------------------
    def _bind_upsert_vars(self, txn: "Txn", query_src: str,
                          acl_user: str | None = None):
        """Run the upsert's query on `device` at the txn's read snapshot
        (through `acl_user`'s readable view when ACL is on) and convert
        the executor's rank-space var bindings to uid space."""
        import numpy as np

        from dgraph_tpu_torch.dql.parser import parse_schema_query
        if parse_schema_query(query_src) is not None:
            raise ValueError("schema{} queries cannot drive an upsert")
        with self._reading(txn.start_ts) as ts:
            store = self._query_view(ts, acl_user)
            out, ex = self._engine(store).query_with_vars(query_src)
        uid_vars = {
            name: store.uid_of(np.asarray(ranks, np.int32)).tolist()
            for name, ranks in ex.uid_vars.items()}
        val_vars = {}
        for name, env in ex.val_vars.items():
            ranks = np.fromiter(env.keys(), np.int32, len(env))
            uids = store.uid_of(ranks)
            val_vars[name] = dict(zip(uids.tolist(), env.values()))
        counts = {n: len(u) for n, u in uid_vars.items()}
        for n, env in val_vars.items():
            counts.setdefault(n, len(env))
        return out, uid_vars, val_vars, counts

    def _check_txn_acl(self, txn: "Txn", acl_user: str | None) -> None:
        """Write-permission check over everything buffered in a txn."""
        if self.acl is None or acl_user is None:
            return
        m = txn.mutation
        touched = {e[1] for e in (m.edge_sets + m.edge_dels
                                  + m.val_sets + m.val_dels)}
        self.acl.check_mutation(acl_user, touched)

    def _run_upsert(self, commit_now: bool, start_ts: int | None,
                    run, deadline_ms: float | None = None) -> dict:
        """Txn bookkeeping shared by the RDF and JSON upsert forms;
        `run(txn)` performs query + substitution + buffered mutates and
        returns (queries_json, uids, applied)."""
        with self._request("mutate", deadline_ms):
            created = not start_ts
            txn = self.txn(start_ts) if start_ts else self.new_txn()
            try:
                out, uids, applied = run(txn)
                if commit_now:
                    txn.commit()
                return {"uids": uids, "queries": out, "applied": applied,
                        "txn": {"start_ts": txn.start_ts,
                                "commit_ts": txn.commit_ts}}
            except TxnAborted:
                txn.discard()
                raise
            except Exception:
                if commit_now or created:
                    txn.discard()
                raise

    def upsert(self, src: str, commit_now: bool = True,
               start_ts: int | None = None,
               acl_user: str | None = None,
               deadline_ms: float | None = None) -> dict:
        """Upsert block: run the query at the txn's read_ts, bind vars,
        evaluate @if conditions, substitute uid(v)/val(v) into the
        mutations, commit through the normal conflict path (reference:
        edgraph upsert semantics)."""
        from dgraph_tpu_torch.dql.upsert import (eval_cond, parse_upsert,
                                                 substitute)

        req = parse_upsert(src)

        def run(txn):
            out, uid_vars, val_vars, counts = self._bind_upsert_vars(
                txn, req.query_src, acl_user)
            uids: dict[str, str] = {}
            applied = 0
            for m in req.mutations:
                if not eval_cond(m.cond, counts):
                    continue
                set_rdf = substitute(m.set_rdf, uid_vars, val_vars)
                del_rdf = substitute(m.del_rdf, uid_vars, val_vars)
                if set_rdf or del_rdf:
                    uids.update(txn.mutate(set_nquads=set_rdf or None,
                                           del_nquads=del_rdf or None))
                    applied += 1
            self._check_txn_acl(txn, acl_user)
            return out, uids, applied

        return self._run_upsert(commit_now, start_ts, run,
                                deadline_ms=deadline_ms)

    def upsert_json(self, query: str, cond: str = "",
                    set_json=None, del_json=None, commit_now: bool = True,
                    start_ts: int | None = None,
                    acl_user: str | None = None,
                    deadline_ms: float | None = None) -> dict:
        """The JSON upsert form: {"query", "cond", "set"/"delete" as JSON
        mutation lists with uid(v)/val(v) references}."""
        from dgraph_tpu_torch.dql.upsert import (_parse_cond, eval_cond,
                                                 substitute_json)

        cond_tree = None
        if cond:
            inner = cond.strip()
            if inner.startswith("@if"):
                inner = inner[3:].strip()
            cond_tree = _parse_cond(inner)

        def run(txn):
            out, uid_vars, val_vars, counts = self._bind_upsert_vars(
                txn, query, acl_user)
            uids: dict[str, str] = {}
            applied = 0
            if eval_cond(cond_tree, counts):
                set_sub = (substitute_json(set_json, uid_vars, val_vars)
                           if set_json else None)
                del_sub = (substitute_json(del_json, uid_vars, val_vars)
                           if del_json else None)
                if set_sub or del_sub:
                    uids.update(txn.mutate(set_json=set_sub or None,
                                           del_json=del_sub or None))
                    applied += 1
            self._check_txn_acl(txn, acl_user)
            return out, uids, applied

        return self._run_upsert(commit_now, start_ts, run,
                                deadline_ms=deadline_ms)

    def commit_or_abort(self, start_ts: int, abort: bool = False,
                        deadline_ms: float | None = None) -> int:
        """reference: Server.CommitOrAbort. Returns commit_ts (0 on abort)."""
        with self._request("mutate", deadline_ms):
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
        # LAST cancellation point on the write path: past here the WAL
        # append and the in-memory apply run to completion together. It
        # runs while the txn is still open, so the caller's discard
        # aborts its start_ts in the oracle (the reference checks in
        # `_commit`, after the txn is marked done, and its start_ts then
        # stays pending and pins the gc watermark)
        dl.checkpoint("commit")
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
