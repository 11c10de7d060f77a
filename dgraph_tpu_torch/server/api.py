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
with the priors' summary.

The front end (server/http.py) serves an Alpha over HTTP. Its two
guards live here: `attach_admission` arms admission control
(server/admission.py), whose token the shell takes with the request's
predicted cost, and `acl` (server/acl.AclManager) hides the predicates
an `acl_user` may not read (`_query_view`) and refuses writes to those
it may not write. A shed (`ServerOverloaded`), a client's cancel and an
ACL refusal are not failed serves and stay out of `query_errors_total`.

The cluster half (reference `server/api.py:556-739` and `:1096-1962`):
with `groups` set (`cluster.start_cluster_alpha`) the Alpha is one node
of a cluster of Zero and groups of replicas. Reads verify every group
peer's broadcast chain first (`_verify_read_chains`, the read gate: a
minority side raises `ReadUnavailable`) and run over a routed view
(`cluster/routed.py`): a foreign tablet is pulled from its owning group
(`_fetch_tablet`, cached per predicate, version and vocabulary width in
`api.tablet`), or a small-frontier hop runs on its owner (`remote_hop`,
ServeTask). Commits stage to the group's replicas and apply once a
majority durably logged them (`_apply_and_broadcast`; a minority side
raises `NoQuorum`); every record rides a chained broadcast that a
replica which missed one catches up on through FetchLog. The other
groups' replicas fail over in order (`Groups.call_group`), and a hop
every replica refused falls back to the whole-tablet pull: both are the
reference's network semantics, counted in `failover_total{rpc=}`, and
neither is a device fallback. No lock here is held across an RPC that
the same process's handler could need: the RPCs of the commit run under
this node's `_apply_lock` only, which a handler of ANOTHER node never
takes.

Every request registers with the flight recorder's watchdog
(`flightrec.track_request`); the CLI (`cli.py`) serves it as a process.
With `mesh=` (a `parallel/mesh.Mesh`, of this process's devices or
across processes) every engine the Alpha makes serves its expansions
sharded. Across processes the serving is SPMD: every rank's Alpha must
receive the same requests in the same order (send each to the lead,
rank 0, first or to every rank at once), and what one rank could decide
differently the lead decides for all: in `_request` the lead admits or
sheds each request and grants it a turn, and every rank runs the
granted requests one at a time in the lead's order. Deliberate difference: no kernel group is
served query by query after a failure: any failure of a group, an allocation failure its
evict-and-retry did not absorb among them, raises out of `query_batch`
(`engine/batch.py`).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.cluster.oracle import Oracle, TxnAborted
from dgraph_tpu_torch.loader.chunker import NQuad, parse_json, parse_rdf
from dgraph_tpu_torch.loader.xidmap import XidMap
from dgraph_tpu_torch.server.admission import ServerOverloaded
from dgraph_tpu_torch.store.mvcc import MVCCStore, Mutation
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.store.types import Kind, hash_password
from dgraph_tpu_torch.utils import (costprior, costprofile, flightrec,
                                    locks, memgov, tracing)
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["Alpha", "Txn", "TxnAborted", "NoQuorum", "ReadUnavailable",
           "StageRefused"]


class NoQuorum(Exception):
    """Commit refused: a majority of the replica group did not durably
    log the record (reference: a raft proposal that cannot commit on the
    minority side of a partition). The write was NOT applied locally and
    the client must not treat it as acknowledged."""


class ReadUnavailable(Exception):
    """Read refused, RETRYABLE: this replica cannot verify that its
    snapshot at the read ts is gap-free (a group peer is unreachable and
    the reachable side is a minority, or a known replication gap could
    not be healed). The reference never hits this state — a raft
    follower only serves what its replicated log proves — so the safe
    answer is an explicit refusal, never a snapshot that never
    existed."""


class StageRefused(Exception):
    """Commit-quorum stage refused: this node has no armed WAL, so its
    ack would certify a durability it cannot provide (the coordinator
    counts stage acks toward the DURABILITY majority — a memory-only ack
    is a lie that loses acknowledged writes on crash). Real deployments
    (Alpha.open, a clustered node's `wal_dir`) always arm the WAL; tests
    opt in explicitly via `allow_volatile_stage`."""


GC_EVERY = 256  # timestamps between oracle/store gc sweeps


def _refusal(e: BaseException) -> dict:
    """The lead's refusal of a request, as its followers read it."""
    if isinstance(e, ServerOverloaded):
        return {"refused": "shed", "message": str(e), "lane": e.lane,
                "reason": e.reason, "retry_after_s": e.retry_after_s}
    if isinstance(e, (dl.DeadlineExceeded, dl.Cancelled)):
        return {"refused": type(e).__name__, "message": str(e),
                "stage": e.stage}
    return {"refused": "error", "message": f"{type(e).__name__}: {e}"}


def _refused(verdict: dict) -> Exception:
    """The exception a follower raises for the lead's refusal: the
    lead's own, with its message, hint and stage."""
    kind, msg = verdict["refused"], verdict["message"]
    if kind == "shed":
        return ServerOverloaded(msg, retry_after_s=verdict["retry_after_s"],
                                lane=verdict["lane"],
                                reason=verdict["reason"])
    if kind == "DeadlineExceeded":
        return dl.DeadlineExceeded(msg, stage=verdict["stage"])
    if kind == "Cancelled":
        return dl.Cancelled(msg, stage=verdict["stage"])
    return RuntimeError(f"the lead refused the request: {msg}")


class _Turns:
    """The order in which requests run over a mesh that spans processes:
    the lead grants turns 0, 1, 2, ... (`grant`) and every rank runs the
    request holding turn t only after turn t - 1 ended here (`turn`).
    A request ends its turn after its turn round (`_in_turn`), which
    every rank that used the mesh in it makes, so turn t's collectives
    never meet turn t + 1's."""

    def __init__(self):
        self._cv = locks.make_condition("alpha.turns")
        self._granted = 0       # turns the lead handed out
        self._next = 0          # the turn whose request may run now
        self._ended: set = set()    # turns past _next that ended
        locks.guarded(self, "alpha.turns")

    def grant(self) -> int:
        with self._cv:
            t = self._granted
            self._granted += 1
            return t

    def skip(self, t: int) -> None:
        """Turn `t` ends without running (its grant never left)."""
        with self._cv:
            self._end(t)

    def _end(self, t: int) -> None:
        """Caller holds the condition."""
        self._ended.add(t)
        while self._next in self._ended:
            self._ended.discard(self._next)
            self._next += 1
        self._cv.notify_all()

    @contextlib.contextmanager
    def turn(self, t: int, timeout_s: float):
        """Run the block in turn `t`: wait until every earlier turn has
        ended here, at most `timeout_s` (then raise: a request the lead
        granted before never reached this rank)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._next == t, timeout_s):
                waiting = self._next
                self._end(t)
                raise RuntimeError(
                    f"turn {t}: turn {waiting} has not ended here within "
                    f"{timeout_s:g} s (every rank must receive the "
                    f"requests the lead granted)")
        try:
            yield
        finally:
            with self._cv:
                self._end(t)


def _register_tablet_cache(alpha) -> None:
    """Join the pulled-tablet cache to the process memory governor as
    `api.tablet` (host budget, oldest-inserted first: an evicted tablet
    is pulled again from its owner). Evicting an entry also drops the
    device copies, ELL blocks and runners built over it, on its host
    (`engine/batch.py:release_host`). The callbacks close over a weakref
    and take the Alpha's own state lock; the governor never holds its
    lock across them."""
    import weakref

    ref = weakref.ref(alpha)

    def nbytes():
        a = ref()
        if a is None:
            return 0
        with a._state_lock:
            vals = list(a._tablet_cache.values())
        return sum(memgov.estimate_nbytes(v) for v in vals)

    def evict_one():
        a = ref()
        if a is None:
            return 0
        with a._state_lock:
            if not a._tablet_cache:
                return 0
            v = a._tablet_cache.pop(next(iter(a._tablet_cache)))
        _release_tablet(v)
        return memgov.estimate_nbytes(v)

    memgov.GOVERNOR.register("api.tablet", "host", nbytes, evict_one,
                             owner=alpha)


def _release_tablet(entry) -> None:
    """A `_tablet_cache` entry left the cache: drop what its host holds
    on the device (the entry's last element is its host Store)."""
    from dgraph_tpu_torch.engine.batch import release_host
    release_host(entry[-1])


def _tablet_host(pred: str, pd, view) -> Store:
    """The Store a pulled tablet's kernel caches live on: the tablet
    alone, over `view`'s vocabulary (cluster/routed.py)."""
    return Store(view.uids, view.schema, {pred: pd})


class Alpha:
    """Data server: oracle + MVCC store + query engine, alone or as one
    node of a cluster (`groups`).

    `device` is where reads run; it defaults to the card and raises
    without one unless the caller names "cpu". `oracle` is Zero's
    (`cluster/zero.RemoteOracle`) on a clustered node."""

    def __init__(self, base: Store | None = None,
                 device_threshold: int = 512, base_ts: int = 0,
                 device=DEFAULT_DEVICE, *, wal=None, oracle=None,
                 groups=None, mesh=None):
        from dgraph_tpu_torch.engine.execute import check_mesh
        self.device = resolve_device(device)
        # parallel/mesh.Mesh | None: every engine this Alpha makes serves
        # its expansions sharded over it
        self.mesh = check_mesh(mesh, self.device)
        self.oracle = oracle if oracle is not None else Oracle()
        self.mvcc = MVCCStore(base=base, base_ts=base_ts)
        self.oracle.bump_ts(base_ts)
        self.xidmap = XidMap(self.oracle)
        self.device_threshold = device_threshold
        self.wal = wal  # store.wal.WAL once attached: fsync'd commit log
        self.groups = groups  # cluster.groups.Groups | None
        # tablet freshness learned from the mutation broadcast: pred →
        # latest commit_ts anywhere; _stale_preds = foreign tablets whose
        # latest version this node has NOT applied locally
        self.tablet_versions: dict[str, int] = {}
        self._stale_preds: set[str] = set()
        # pulled foreign tablets: (pred, version) → (pd, vocabulary
        # width, last uid, host) and (pred, version, width) → (pd, host);
        # the host is the Store their kernel caches live on
        self._tablet_cache: dict[tuple, tuple] = {}
        # broadcast chaining (replica catch-up): what we last APPLIED from
        # each origin node, what we last SENT, and peers that missed one of
        # our broadcasts (excluded from read failover until a later chained
        # broadcast succeeds — the receiver catches up before acking)
        self._last_from: dict[int, int] = {}
        self._last_sent_ts = 0
        self._prev_sent_ts = 0
        self._suspect_peers: dict[str, int] = {}
        # detected-but-unhealed per-origin chain gaps: origin node id →
        # since_ts of the oldest record we may be missing from it. Reads
        # must heal these (FetchLog) or refuse (ReadUnavailable) before
        # serving
        self._origin_gaps: dict[int, int] = {}
        # read gate state: monotonic time of the last full chain
        # verification; read_lease_s > 0 lets reads inside the lease skip
        # re-probing (bounded staleness); 0 = verify every read (strict)
        self._read_verified_at = 0.0
        self.read_lease_s = 0.0
        # test-only opt-in: accept commit-quorum stages without an armed
        # WAL (the ack is then NOT crash-durable — see StageRefused)
        self.allow_volatile_stage = False
        self._warned_volatile_stage = False
        # commit-quorum staging: ts → (Mutation, origin node id) durably
        # logged but undecided (raft "log entry below commit index")
        self._pending: dict[int, tuple[Mutation, int]] = {}
        # oldest ts the local WAL still covers (records at or below were
        # absorbed by a checkpoint); FetchLog answers "complete" only above
        self._wal_floor = base_ts
        self.remote_hop_max = 4096  # frontier cap for per-hop routing
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
        self._apply_lock = locks.make_lock("alpha.apply")
        self._state_lock = locks.make_lock("alpha.state")
        # grant order over a mesh that spans processes (`_in_turn`)
        self._turns = _Turns()
        self._open_txns: dict[int, Txn] = {}
        self._active_reads: dict[int, int] = {}
        self._gc_tick = 0
        if base is not None and base.n_nodes:
            self.oracle.bump_uid(int(base.uids[-1]))
        locks.guarded(self, "alpha.state")
        _register_tablet_cache(self)

    @classmethod
    def open(cls, p_dir: str, device_threshold: int = 512,
             sync: bool = True, memory_budget: int | None = None,
             device=DEFAULT_DEVICE, mesh=None) -> "Alpha":
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
                    base_ts=base_ts, device=device, mesh=mesh)
        if base is not None and hasattr(base.preds, "heal_cb"):
            # out-of-core: a tablet fault that fails its integrity check
            # heals from a group replica once this alpha joins a cluster;
            # alone it stays a typed refusal naming the file
            base.preds.heal_cb = alpha._heal_corrupt_tablet
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
        """Replay + arm a WAL on this Alpha — the boot leg shared by
        Alpha.open and a clustered node's start (a node whose stage acks
        certified durability MUST recover its log on restart). Resolves
        pend/dec staging inline (a pend applies at its dec:1 position),
        re-arms undecided pends, seeds the broadcast chain, then opens the
        WAL for appends. Returns (max_ts, max_uid) seen, for the caller's
        oracle and Zero watermarks."""
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
        # seed the broadcast chain at the replayed horizon: prev_ts on our
        # first post-restart broadcast must not regress to 0 (a receiver
        # would miss the gap check); a too-HIGH prev only triggers a
        # harmless spurious catch-up on peers
        self._last_sent_ts = max_ts
        # re-arm undecided staged records (still durable, still
        # invisible): a peer's decision marker or catch-up resolves them
        # after the restart; origin 0 = unknown after restart. Under the
        # state lock: a cluster restart can already be receiving chained
        # broadcasts on gRPC threads
        with self._state_lock:
            for ts, mut in pends.items():
                if not self.mvcc.has_applied(ts):
                    self._pending[ts] = (mut, 0)
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
                self._wal_floor = max(self._wal_floor, ts)
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
            # graftlint: allow(split-critical-section): exclusive branches — the streaming path RETURNED above; the two acquisitions never run in one call
            self._wal_floor = max(self._wal_floor, ts)
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
        budgets requests that bring none of their own. Over a mesh that
        spans processes the lead's controller decides for every rank
        (`_request`)."""
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
                 query_text: str | None = None, key=None):
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
        `query_errors_total{lane=}`.

        Over a mesh that spans processes the request runs in the lead's
        turn (`_in_turn`): `lane`, `query_text` and `key` (a request's
        other arguments) name it to the other ranks."""
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
                # the flight recorder's watchdog walks this entry: a
                # request running far past `predicted` (or wedged past
                # its deadline) is convicted and dumped with its stack
                with flightrec.track_request(ctx, lane,
                                             predicted_us=predicted,
                                             query=query_text):
                    if self.mesh is not None and self.mesh.spans_processes:
                        with self._in_turn(lane, ctx, predicted,
                                           (query_text, key)):
                            yield ctx
                    elif self.admission is not None:
                        with self.admission.admit(lane, ctx,
                                                  cost_us=predicted):
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

    @contextlib.contextmanager
    def _in_turn(self, lane: str, ctx, predicted, key):
        """A request over a mesh that spans processes, in the lead's
        turn. The lead (rank 0) decides: with admission attached it
        admits or sheds as alone (the queue-exit budget check
        included), then grants the request the next turn with its route
        promotions (`costprior.promotions`); a refusal is published
        instead and raised. Every other rank reads that verdict
        (`parallel/mesh.agree`, one store round trip under
        `agree_key("request", lane, key)`) and follows it, never its own
        controller's or priors' answer: it sheds what the lead shed,
        with its hint, and serves what the lead admitted, however full
        its own lane (`AdmissionController.follow`). Every rank then
        runs the granted requests one at a time in grant order, the
        lead's promotions ambient (`parallel/mesh.following`), so the
        collectives of their mesh programs come in one order on every
        rank. Each request runs as one `parallel/mesh.lockstep` scope
        named by its turn: a failure on one rank (an expired budget, an
        allocation failure its retry did not absorb) is reported at a
        status round, so every rank that meets it at a collective raises
        it too, and the request gives up its turn only after its turn
        round, where every rank has learned of it. A read always makes
        that round (so every rank must receive a read before any answers
        it); a write makes it only when it made a round (`lazy`), so a
        write that uses no collective may reach one rank after another.
        A write that one rank left before its first round ends on the
        ranks that went on into its collectives, at their next round."""
        from dgraph_tpu_torch.parallel import mesh as pmesh
        mesh = self.mesh
        name = pmesh.agree_key("request", lane, key)
        with contextlib.ExitStack() as held:
            if mesh.is_lead:
                try:
                    if self.admission is not None:
                        held.enter_context(self.admission.admit(
                            lane, ctx, cost_us=predicted))
                        ctx.check("admission")
                except BaseException as e:
                    pmesh.agree(mesh, name, _refusal(e))
                    raise
                verdict = {"turn": self._turns.grant(),
                           "promoted": costprior.promotions()}
                try:
                    pmesh.agree(mesh, name, verdict)
                except BaseException:
                    self._turns.skip(verdict["turn"])
                    raise
            else:
                verdict = pmesh.agree(mesh, name)
                if "refused" in verdict:
                    e = _refused(verdict)
                    if self.admission is not None and isinstance(
                            e, ServerOverloaded):
                        self.admission.follow_shed(e, cost_us=predicted)
                    raise e
                if self.admission is not None:
                    held.enter_context(self.admission.follow(
                        lane, cost_us=predicted))
            held.enter_context(self._turns.turn(verdict["turn"],
                                                pmesh.group_timeout_s()))
            # a write closes with a round only when it made one, so one
            # that uses no collective may reach one rank after another
            with pmesh.following(verdict["promoted"]), pmesh.lockstep(
                    mesh, "request", verdict["turn"], lazy=lane != "read"):
                yield

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
                # graftlint: allow(split-critical-section): the register/recheck/unregister retry protocol documented above — each acquisition is an independent refcount step, and the gc race it exists to close is re-checked per attempt
                self._active_reads[ts] -= 1
                if not self._active_reads[ts]:
                    del self._active_reads[ts]
        try:
            yield ts
        finally:
            with self._state_lock:
                # graftlint: allow(split-critical-section): refcount release — the earlier read registered this ts; decrementing in its own acquisition is the protocol, not check-then-act
                self._active_reads[ts] -= 1
                if not self._active_reads[ts]:
                    del self._active_reads[ts]

    def _query_view(self, ts: int, acl_user: str | None = None) -> Store:
        """The store a query at `ts` executes against: the MVCC snapshot,
        routed to the other groups' tablets on a clustered node
        (cluster/routed.py), restricted to what `acl_user` may read when
        ACL is on — in that order."""
        store = self.mvcc.read_view(ts)
        if self.groups is not None:
            from dgraph_tpu_torch.cluster.routed import routed_view
            store = routed_view(self, store, ts)
        if self.acl is not None and acl_user is not None:
            store = self.acl.readable_view(acl_user, store)
        return store

    def _verify_read_chains(self, ts: int) -> None:
        """Partition-safe read gate (reference: a raft follower never
        serves a log state that did not exist). Before a read at `ts` is
        served, every group peer's broadcast chain must be verifiably
        gap-free: the peer's chain head (last ts it broadcast) is
        compared against the last record this node APPLIED from it, and
        any missed tail is pulled via FetchLog BEFORE the read runs.
        Recorded gaps (`_origin_gaps` — a receive-time catch-up that
        failed) must heal the same way.

        Undecided FOREIGN pends are part of the bar, not an exception:
        a staged record whose DecisionMsg was lost may already be
        client-acked — the decision is durable in the coordinator's WAL
        — and serving the pre-commit state would hand a read-modify-
        write txn a lost update (the seeded partition fuzz catches
        exactly this: the stale read predates the commit's ts, so
        conflict detection cannot). The gate resolves such pends
        through the origin's (or any reachable peer's) resolved log; a
        pend that stays unresolved with its origin REACHABLE is
        genuinely undecided — not acked before this read began — and
        may be invisibly skipped.

        An unreachable peer leaves its chain unverifiable. If the
        reachable part of the group (counting this node) is still a
        MAJORITY, the missed tails are pulled from the reachable peers'
        resolved logs instead — every client-acked commit is resolved
        in its coordinator's WAL, and majority staging puts it on at
        least one reachable node. But a pend whose UNREACHABLE origin
        may hold the only copy of its decision blocks the read
        (ReadUnavailable) — the alternative is the lost update above.
        On the minority side nothing can be verified: the read raises
        ReadUnavailable (retryable) rather than serve a snapshot that
        never existed.

        `read_lease_s` bounds probe cost: a successful verification
        stays valid that long (0 = verify every read, strict; a
        positive lease explicitly trades bounded staleness inside the
        window for fewer probes)."""
        if self.groups is None:
            return
        replicas = [a for a in self.groups.group_addrs(self.groups.gid)
                    if a != self.groups.my_addr]
        if not replicas:
            return
        with self._state_lock:
            gaps = dict(self._origin_gaps)
            fresh = (self.read_lease_s > 0
                     and time.monotonic() - self._read_verified_at
                     <= self.read_lease_s)
        if fresh and not gaps:
            return
        import grpc as _grpc
        majority = (len(replicas) + 1) // 2 + 1
        my_node = self.groups.node_id
        with self._state_lock:
            pend_origins = {org for _t, (_m, org) in self._pending.items()
                            if org and org != my_node}
        unreachable: dict[str, int | None] = {}
        reachable: list[str] = []
        for addr in replicas:
            # per-peer probe budget gate: a read whose deadline died
            # mid-verification raises HERE (retryable), with no chain
            # state half-advanced — _last_from/_origin_gaps only move
            # after a completed catch-up
            dl.checkpoint("chain_head")
            t0 = time.perf_counter()
            try:
                node, head = self.groups.pool(addr).chain_head()
            except _grpc.RpcError:
                unreachable[addr] = self.groups.node_of_addr(addr)
                continue
            METRICS.observe("rpc_latency_us",
                            (time.perf_counter() - t0) * 1e6,
                            rpc="chain_head")
            reachable.append(addr)
            if not node:
                continue  # peer not in cluster mode: no chain to check
            last = self._last_from.get(node, 0)
            if head <= last and node not in gaps \
                    and node not in pend_origins:
                continue
            since = min(last, gaps.get(node, last))
            if node in pend_origins:
                # a lost-decision pend resolves from the origin's log;
                # pull from below the oldest pend so the decision (or
                # abort marker) is in the stream
                with self._state_lock:
                    pts = [t for t, (_m, org) in self._pending.items()
                           if org == node]
                if pts:
                    since = min(since, min(pts) - 1)
            try:
                _complete, seen = self.catch_up(addr, since_ts=since)
            except _grpc.RpcError:
                unreachable[addr] = node
                reachable.pop()
                continue
            pend_origins.discard(node)  # resolved, or truly undecided
            with self._state_lock:
                # graftlint: allow(split-critical-section): the pop lands only after a COMPLETED catch-up covering everything this gap recorded; a gap recorded concurrently re-arms on the next chained receive or read probe
                self._origin_gaps.pop(node, None)
            gaps.pop(node, None)
            if seen >= head:
                # the probed head itself came back resolved: everything
                # the peer ever broadcast is applied here — advance the
                # chain so the next read (and the next chained receive)
                # doesn't re-pull. A head still pending on the peer
                # (stage leg sent, decision unwritten) must NOT advance:
                # that would hide the record from gap detection.
                self._last_from[node] = max(
                    self._last_from.get(node, 0), head)
        if unreachable:
            if 1 + len(reachable) < majority:
                METRICS.inc("read_unavailable_total", reason="minority")
                raise ReadUnavailable(
                    f"read at ts {ts}: replica(s) "
                    f"{sorted(unreachable)} unreachable and the "
                    f"reachable side is a minority of the group — "
                    f"cannot verify the snapshot is gap-free; retry")
            # majority fallback: pull the unreachable origins' tails
            # from the reachable peers' resolved logs
            floors = [self._last_from.get(n, 0)
                      for n in unreachable.values() if n is not None]
            floors += [gaps[n] for n in list(gaps)
                       if n in set(unreachable.values())]
            # a pend whose unreachable origin may hold the only copy of
            # its decision must ALSO pull from below the pend
            dead_nodes = {n for n in unreachable.values()
                          if n is not None}
            with self._state_lock:
                dead_pts = [t for t, (_m, org) in self._pending.items()
                            if org in dead_nodes]
            if dead_pts:
                floors.append(min(dead_pts) - 1)
            since = min(floors, default=0)
            healed = False
            for addr in reachable:
                try:
                    self.catch_up(addr, since_ts=since)
                    healed = True
                except _grpc.RpcError:
                    continue
            if healed:
                # the unreachable origin's tail was served by a
                # DIFFERENT replica — the fetch_log failover leg
                METRICS.inc("failover_total", rpc="fetch_log")
            if not healed:
                METRICS.inc("read_unavailable_total",
                            reason="heal_failed")
                raise ReadUnavailable(
                    f"read at ts {ts}: could not pull the tail of "
                    f"unreachable replica(s) {sorted(unreachable)} "
                    f"from any reachable peer; retry")
            with self._state_lock:
                still = [t for t, (_m, org) in self._pending.items()
                         if org in dead_nodes]
            if still:
                # the decision for these staged records may exist only
                # in the unreachable coordinator's WAL: serving without
                # them risks a lost update (stale read below the
                # commit's ts — conflict detection cannot catch it)
                METRICS.inc("read_unavailable_total",
                            reason="undecided_pend")
                raise ReadUnavailable(
                    f"read at ts {ts}: staged record(s) {sorted(still)} "
                    f"from unreachable coordinator(s) are undecided "
                    f"here; retry")
        else:
            with self._state_lock:
                # graftlint: allow(split-critical-section): monotonic freshness stamp — whichever verification finishes last wins, and any concurrent write only ADVANCES the lease; no decision was made on the earlier read
                self._read_verified_at = time.monotonic()

    def _engine(self, store: Store):
        from dgraph_tpu_torch.engine import Engine
        return Engine(store, device=self.device,
                      device_threshold=self.device_threshold, mesh=self.mesh)

    def query(self, dql: str, variables: dict | None = None,
              read_ts: int | None = None,
              acl_user: str | None = None,
              deadline_ms: float | None = None) -> dict:
        """Read-only query at a snapshot (reference: Server.Query). With
        ACL on and an `acl_user`, unreadable predicates are invisible.
        `deadline_ms` bounds the request: the engine's loops checkpoint
        against it and raise a retryable `DeadlineExceeded` within one
        level / BFS iteration of the budget."""
        with self._request("read", deadline_ms, query_text=dql,
                           key=variables):
            with self._reading(read_ts) as ts:
                self._verify_read_chains(ts)
                out = self._engine(self._query_view(ts, acl_user)).query(
                    dql, variables)
        self._maybe_gc()
        return out

    def query_raw(self, dql: str, variables: dict | None = None,
                  read_ts: int | None = None,
                  acl_user: str | None = None,
                  deadline_ms: float | None = None) -> bytes:
        """Serving-path query: response BYTES (engine/emit.py)."""
        with self._request("read", deadline_ms, query_text=dql,
                           key=variables):
            with self._reading(read_ts) as ts:
                self._verify_read_chains(ts)
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
                self._verify_read_chains(ts)
                out = query_batch(self._query_view(ts, acl_user), dqls,
                                  device=self.device,
                                  device_threshold=self.device_threshold,
                                  mesh=self.mesh)
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
        with self._request("mutate", deadline_ms, key=(
                set_nquads, del_nquads, set_json, del_json, commit_now,
                start_ts)):
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
        from dgraph_tpu_torch.dql.parser import parse_schema_query
        if parse_schema_query(query_src) is not None:
            raise ValueError("schema{} queries cannot drive an upsert")
        with self._reading(txn.start_ts) as ts:
            self._verify_read_chains(ts)
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
                    run, deadline_ms: float | None = None,
                    key=None) -> dict:
        """Txn bookkeeping shared by the RDF and JSON upsert forms;
        `run(txn)` performs query + substitution + buffered mutates and
        returns (queries_json, uids, applied); `key` identifies the
        upsert (`_request`)."""
        with self._request("mutate", deadline_ms, key=key):
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
                                deadline_ms=deadline_ms,
                                key=(src, commit_now, start_ts))

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
                                deadline_ms=deadline_ms,
                                key=(query, cond, set_json, del_json,
                                     commit_now, start_ts))

    def commit_or_abort(self, start_ts: int, abort: bool = False,
                        deadline_ms: float | None = None) -> int:
        """reference: Server.CommitOrAbort. Returns commit_ts (0 on abort)."""
        with self._request("mutate", deadline_ms, key=(start_ts, abort)):
            txn = self.txn(start_ts)
            if abort:
                txn.discard()
                return 0
            return txn.commit()

    def alter(self, schema_text: str) -> None:
        """Schema mutation + index rebuild (reference: Server.Alter →
        schema.Update + posting.RebuildIndex). The new snapshot is built
        under the merged schema and swapped in atomically, so concurrent
        queries see either fully-old or fully-new index state. The
        broadcast rides the same chain as mutations, so a peer that
        misses an Alter pulls it (the schema record is in our WAL) on the
        next chained message instead of diverging forever."""
        ts = self.apply_schema_broadcast(schema_text)
        if self.groups is not None:
            with self._apply_lock:
                self._broadcast_chained(
                    ts, lambda c, origin, prev: c.apply_schema(
                        schema_text, ts=ts, origin=origin, prev_ts=prev))

    def drop_attr(self, pred: str) -> None:
        """reference: api.Operation{DropAttr} — delete one predicate's
        data + schema everywhere. Broadcast like Alter."""
        ts = self.apply_drop_attr_broadcast(pred)
        if self.groups is not None:
            with self._apply_lock:
                self._broadcast_chained(
                    ts, lambda c, origin, prev: c.apply_drop_attr(
                        pred, ts=ts, origin=origin, prev_ts=prev))
            import grpc as _grpc
            try:
                # the tablet assignment dies with the predicate
                # (reference: DropAttr deletes it from Zero's map)
                self.groups.zero.remove_tablet(pred)
            except _grpc.RpcError:
                pass  # membership poll self-heals when zero returns

    def apply_drop_attr_broadcast(self, pred: str, ts: int = 0) -> int:
        """Receive/apply a DropAttr (no re-broadcast). The predicate's
        tablet caches reset so a cached foreign copy can't serve dropped
        data."""
        with self._apply_lock:
            ts = ts or self.oracle.read_only_ts()
            if self.wal is not None:
                self.wal.append_drop_attr(pred, ts)
            self.mvcc.drop_predicate(pred, ts)
            with self._state_lock:
                self.tablet_versions.pop(pred, None)
                self._stale_preds.discard(pred)
                dropped = self._pop_tablets(lambda k: k[0] == pred)
        for entry in dropped:
            _release_tablet(entry)
        return ts

    def drop_all(self) -> None:
        """reference: api.Operation{DropAll}. Broadcast like Alter: every
        node must drop or spanning queries diverge against survivors."""
        ts = self.apply_drop_broadcast()
        if self.groups is not None:
            with self._apply_lock:
                self._broadcast_chained(
                    ts, lambda c, origin, prev: c.apply_drop(
                        ts=ts, origin=origin, prev_ts=prev))

    def apply_drop_broadcast(self, ts: int = 0) -> int:
        """Receive/apply a DropAll (no re-broadcast). Tablet caches must
        reset too — a cached foreign tablet would keep serving pre-drop
        data locally. Returns the drop's ts (chained broadcasts key on
        it)."""
        with self._apply_lock:
            ts = ts or self.oracle.read_only_ts()
            if self.wal is not None:
                self.wal.append_drop(ts)
            self.mvcc = MVCCStore()
            self.xidmap = XidMap(self.oracle)
            with self._state_lock:
                self._open_txns.clear()
                self.tablet_versions.clear()
                self._stale_preds.clear()
                dropped = self._pop_tablets(lambda k: True)
        for entry in dropped:
            _release_tablet(entry)
        return ts

    # -- commit path (worker/draft.go applyMutations analog) ----------------
    def _commit(self, txn: "Txn") -> int:
        # the last cancellation point ran in Txn.commit: past it the
        # two-phase stage/decide protocol runs to completion —
        # interrupting between stage and decide would leak an
        # undecided pend on every replica that acked
        with self._apply_lock:
            if self.groups is not None:
                # pre-flight BEFORE the oracle assigns a commit_ts: a
                # minority-side coordinator refuses up front instead of
                # burning a timestamp + conflict window on a commit the
                # group cannot accept. (A link that dies between this
                # probe and the stage still burns the ts — readers never
                # see it, but its conflict keys can spuriously abort
                # concurrent txns until retention expires; the window is
                # one RPC round.)
                self._preflight_quorum()
            commit_ts = self.oracle.commit(
                txn.start_ts, txn.mutation.conflict_keys(self.mvcc.schema))
            if self.groups is not None:
                self._apply_and_broadcast(txn.mutation, commit_ts)
                return commit_ts
            # write-ahead: on disk before the in-memory apply, so a crash
            # between the two replays the record (reference: raft entry
            # fsync before posting-list apply)
            if self.wal is not None:
                self.wal.append(txn.mutation, commit_ts)
            self.mvcc.apply(txn.mutation, commit_ts)
            return commit_ts

    # -- cluster write/read plumbing (worker/draft.go + task.go analogs) -----
    def _apply_and_broadcast(self, mut: Mutation, commit_ts: int) -> None:
        """Replicated commit with MAJORITY acknowledgment (reference:
        worker/draft.go proposeAndWait over etcd raft, collapsed to a
        two-phase chained broadcast):

        Phase 1 — STAGE: the record is durably logged as pending on this
        node and shipped with `stage=true` to every replica of this
        group; each replica durably logs it (no apply) and acks. Phase 2
        — DECIDE: when ≥ majority of the group (counting this node)
        logged it, the decision marker is written, the record applies
        locally, replicas get DecisionMsg (best-effort: a replica that
        misses it resolves through FetchLog, whose resolved stream serves
        the decision durably), and non-group nodes get the normal full
        broadcast. Under majority loss the decision is ABORT: nothing was
        applied anywhere, the client gets NoQuorum, and the staged pend
        resolves to an abort marker — the minority side of a partition
        refuses writes instead of diverging.

        Each message chains to the sender's previous one (origin +
        prev_ts): a receiver that missed a record detects the gap on the
        next chained message and pulls the tail via FetchLog BEFORE
        applying/acking. A peer that misses a broadcast is marked suspect
        (skipped by read failover); a later successful chained broadcast
        clears it, because the ack implies the peer converged first.
        Single-replica groups skip staging (majority of one is self)."""
        from dgraph_tpu_torch.store.wal import mut_to_bytes
        gid = self.groups.gid
        replicas = [a for a in self.groups.group_addrs(gid)
                    if a != self.groups.my_addr]
        if replicas:
            majority = (len(replicas) + 1) // 2 + 1
            if self.wal is not None:
                self.wal.append_pend(mut, commit_ts)
            with self._state_lock:
                self._pending[commit_ts] = (mut, self.groups.node_id)
            blob = mut_to_bytes(mut)
            acks = 1 + self._broadcast_chained(
                commit_ts,
                lambda c, origin, prev: c.apply_mutation(
                    blob, commit_ts, origin=origin, prev_ts=prev,
                    stage=True),
                addrs=replicas)
            if acks < majority:
                if self.wal is not None:
                    self.wal.append_decision(commit_ts, False)
                with self._state_lock:
                    self._pending.pop(commit_ts, None)
                self._send_decisions(replicas, commit_ts, False)
                METRICS.inc("noquorum_total", phase="stage")
                raise NoQuorum(
                    f"commit {commit_ts}: {acks}/{len(replicas) + 1} "
                    f"replicas durably logged it; majority "
                    f"{majority} required")
            if self.wal is not None:
                self.wal.append_decision(commit_ts, True)
            with self._state_lock:
                self._pending.pop(commit_ts, None)
            self.apply_committed(mut, commit_ts, log_wal=False)
            self._send_decisions(replicas, commit_ts, True)
        else:
            self.apply_committed(mut, commit_ts)
        others = [a for a in self.groups.other_addrs()
                  if a not in replicas]
        # the chain advances exactly once per ts: on the stage leg when
        # replicas exist, else on this cross-group leg (a single-replica
        # group that never advanced would pin prev_ts and kill gap
        # detection on every peer)
        self._broadcast_chained(
            commit_ts, lambda c, origin, prev: c.apply_mutation(
                mut_to_bytes(mut), commit_ts, origin=origin,
                prev_ts=prev),
            addrs=others, advance=not replicas)

    def _preflight_quorum(self) -> None:
        """Cheap reachability probe of the replica group before taking a
        commit timestamp (raft leaders know liveness from heartbeats;
        an any-coordinator design must ask)."""
        import grpc as _grpc
        gid = self.groups.gid
        replicas = [a for a in self.groups.group_addrs(gid)
                    if a != self.groups.my_addr]
        if not replicas:
            return
        majority = (len(replicas) + 1) // 2 + 1
        alive = 1
        for addr in replicas:
            if alive >= majority:
                return
            try:
                self.groups.pool(addr).ping()
                alive += 1
            except _grpc.RpcError:
                continue
        if alive < majority:
            METRICS.inc("noquorum_total", phase="preflight")
            raise NoQuorum(
                f"only {alive}/{len(replicas) + 1} group replicas "
                f"reachable; majority {majority} required")

    def _send_decisions(self, replicas, commit_ts: int,
                        commit: bool) -> None:
        """Phase-2 fan-out; failures leave the replica to resolve via
        FetchLog (its pend is durable, our decision marker is durable)."""
        import grpc as _grpc
        for addr in replicas:
            try:
                self.groups.pool(addr).apply_decision(
                    commit_ts, commit, origin=self.groups.node_id)
            except _grpc.RpcError:
                with self._state_lock:
                    self._suspect_peers.setdefault(addr, commit_ts)
                self.groups.invalidate(addr)

    def _broadcast_chained(self, ts: int, send, addrs=None,
                           advance: bool = True) -> int:
        """Send one chained record to `addrs` (default: every peer);
        track suspects; return the number of successful sends. Callers
        hold _apply_lock, which serializes the prev/_last_sent_ts chain.
        `advance=False` reuses the previous chain position — the second
        leg of a two-leg send for the same ts (stage to the replica
        group, then the full record to other groups)."""
        import grpc as _grpc
        if advance:
            self._prev_sent_ts = self._last_sent_ts
            self._last_sent_ts = ts
        prev = self._prev_sent_ts
        ok = 0
        for addr in (self.groups.other_addrs() if addrs is None
                     else addrs):
            try:
                send(self.groups.pool(addr), self.groups.node_id, prev)
                ok += 1
                with self._state_lock:
                    self._suspect_peers.pop(addr, None)
            except _grpc.RpcError as e:
                # the peer missed this record: its tablets may serve stale
                # reads — exclude it from failover until it resyncs (the
                # chained gap triggers that on our next broadcast). Drop
                # the pooled channel so the retry isn't stuck in backoff.
                with self._state_lock:
                    self._suspect_peers.setdefault(addr, ts)
                self.groups.invalidate(addr)
                from dgraph_tpu_torch.utils import logging as xlog
                xlog.get("alpha").warning(
                    "broadcast of ts %d to %s failed (%s); peer marked "
                    "suspect until it catches up",
                    ts, addr, e.code() if hasattr(e, "code") else e)
                continue
        return ok

    def _chain_catch_up(self, origin: int, since_ts: int) -> None:
        """Pull the missed (since_ts, …] tail from `origin`. On ANY
        failure (unknown address, gRPC receive error) the gap is
        RECORDED instead of propagated: the enclosing stage/broadcast
        RPC must still succeed — refusing it would make an asymmetric
        partition cascade — but the read gate then refuses or heals the
        hole before any snapshot is served (never silently proceed past
        a known gap)."""
        addr = self.groups.addr_of_node(origin)
        try:
            if addr is None:
                raise LookupError(f"origin node {origin} has no known "
                                  f"address")
            self.catch_up(addr, since_ts=since_ts)
        except Exception as e:  # noqa: BLE001 — gap recorded, not lost
            with self._state_lock:
                known = self._origin_gaps.get(origin)
                self._origin_gaps[origin] = (since_ts if known is None
                                             else min(known, since_ts))
            from dgraph_tpu_torch.utils import logging as xlog
            xlog.get("alpha").warning(
                "catch-up from origin %d above ts %d failed (%s); gap "
                "recorded — reads heal or refuse until it resolves",
                origin, since_ts, e)
        else:
            with self._state_lock:
                # graftlint: allow(split-critical-section): pop only after this call's own catch_up SUCCEEDED; a concurrently recorded gap re-arms on the next chained receive or read probe
                self._origin_gaps.pop(origin, None)

    def receive_stage(self, mut: Mutation, ts: int, origin: int,
                      prev_ts: int) -> None:
        """Commit-quorum phase-1 receive: chain gap-check, then durably
        log the record as PENDING — no apply. The ack this produces is
        the durability certificate the coordinator counts toward
        majority (reference: raft AppendEntries success) — which is why
        a node with no armed WAL must REFUSE (StageRefused →
        FailedPrecondition on the wire) instead of acking a durability
        it cannot provide."""
        if self.wal is None and not self.allow_volatile_stage:
            raise StageRefused(
                f"stage of ts {ts} refused: no WAL armed — this node's "
                f"ack would count toward the coordinator's durability "
                f"majority without being crash-durable")
        if origin:
            last = self._last_from.get(origin, 0)
            if prev_ts > last:
                self._chain_catch_up(origin, since_ts=last)
            self._last_from[origin] = max(
                self._last_from.get(origin, 0), ts)
            self._resolve_stale_pendings(origin, ts)
        with self._apply_lock:
            if self.mvcc.has_applied(ts):
                return  # already resolved via catch-up
            if self.wal is not None:
                self.wal.append_pend(mut, ts)
            elif not self._warned_volatile_stage:
                # explicit test-only opt-in (allow_volatile_stage): the
                # ack the coordinator counts toward its durability
                # majority is memory-only here. Real deployments
                # (Alpha.open / cli) always arm the WAL.
                self._warned_volatile_stage = True
                from dgraph_tpu_torch.utils import logging as xlog
                xlog.get("alpha").warning(
                    "commit-quorum stage accepted WITHOUT a WAL: acks "
                    "from this node are not crash-durable")
            with self._state_lock:
                self._pending[ts] = (mut, origin)

    def _resolve_stale_pendings(self, origin: int, before_ts: int) -> None:
        """A record from `origin` at `before_ts` proves every EARLIER ts
        it staged here is decided in its durable log (the chain only
        advances after the decision marker is written) — a lost
        DecisionMsg is recovered by pulling the origin's resolved log.
        The chain position alone can't catch this: staging advanced
        _last_from, so there is no prev_ts gap to detect.

        A stale ts the fetch does NOT resolve is an ORPHAN: the origin
        crashed between stage and decision and restarted (its own replay
        discards undecided pends — the client was never acked). It is
        resolved as ABORT here; should the origin somehow have committed
        it after all, the committed record is in its resolved log and
        ordinary gap catch-up re-applies it (apply is idempotent).

        The orphan verdict REQUIRES a successful fetch of the origin's
        resolved log: with its address unknown or the pull failing
        (gRPC receive error), the pends are RETAINED — aborting a
        record the origin may have committed would drop an acknowledged
        write; a later chained message retries the resolution. The
        failed pull must also never fail the ENCLOSING stage RPC (the
        coordinator would count this node unreachable over a third
        party's link)."""
        with self._state_lock:
            stale = [t for t, (_m, org) in self._pending.items()
                     if org == origin and t < before_ts]
        if not stale:
            return
        addr = self.groups.addr_of_node(origin)
        fetched = False
        if addr is not None:
            try:
                self.catch_up(addr, since_ts=min(stale) - 1)
                fetched = True
            except Exception as e:  # noqa: BLE001 — retain, retry later
                from dgraph_tpu_torch.utils import logging as xlog
                xlog.get("alpha").warning(
                    "stale-pend resolution fetch from origin %d (%s) "
                    "failed (%s); retaining %d staged record(s)",
                    origin, addr, e, len(stale))
        if not fetched:
            return  # cannot distinguish orphan from lost decision yet
        with self._state_lock:
            orphans = [t for t in stale if t in self._pending]
            for t in orphans:
                # graftlint: allow(split-critical-section): re-validated — only ts still in _pending under THIS acquisition are deleted; a decision that raced the fetch already removed its entry
                del self._pending[t]
        if self.wal is not None:
            for t in orphans:
                self.wal.append_decision(t, False)

    def receive_decision(self, ts: int, commit: bool,
                         origin: int) -> None:
        """Commit-quorum phase-2 receive: resolve a pending record. A
        decision for an unknown ts is ignored — catch-up already
        resolved it (the origin's WAL serves decisions durably)."""
        with self._apply_lock:
            with self._state_lock:
                entry = self._pending.pop(ts, None)
            if entry is None:
                return
            mut, _origin = entry
            if self.wal is not None:
                self.wal.append_decision(ts, commit)
            if commit and not self.mvcc.has_applied(ts):
                self.apply_committed(mut, ts, log_wal=False)

    def receive_broadcast(self, kind: str, obj, ts: int,
                          origin: int, prev_ts: int) -> None:
        """Broadcast receive path with gap detection: if the sender's
        chain skips past what we last saw from it, pull the missed WAL
        tail from the origin BEFORE applying this record. Applies are
        idempotent against duplicates (catch-up may have just pulled the
        very record being delivered)."""
        if origin:
            last = self._last_from.get(origin, 0)
            if prev_ts > last:
                # we missed (last, prev_ts] from this origin
                self._chain_catch_up(origin, since_ts=last)
            self._last_from[origin] = max(
                self._last_from.get(origin, 0), ts)
            self._resolve_stale_pendings(origin, ts)
        if kind == "schema":
            self.apply_schema_broadcast(obj, ts=ts)
        elif kind == "drop":
            self.apply_drop_broadcast(ts=ts)
        elif kind == "drop_attr":
            self.apply_drop_attr_broadcast(obj, ts=ts)
        elif not self.mvcc.has_applied(ts):
            self.apply_committed(obj, ts)

    def catch_up(self, addr: str, since_ts: int) -> tuple[bool, int]:
        """Pull and apply the peer's WAL records above since_ts
        (reference: raft log replay for a lagging follower). Returns
        (complete, seen_max): complete=False when the peer's WAL no
        longer covers since_ts — the caller falls back to snapshot
        resync (mark tablets stale / TabletSnapshot) — and seen_max is
        the highest RESOLVED ts in the fetched stream (0 when empty),
        which the read gate compares against the peer's probed chain
        head to decide whether the chain may advance.

        since_ts is clamped to our own fold floor: records at or below it
        are already inside our snapshots, and re-absorbing them would
        duplicate @list values (apply is set-idempotent per layer, not
        against folded history)."""
        from dgraph_tpu_torch.utils import logging as xlog
        log = xlog.get("alpha")
        # budget gate per RPC leg: the remaining budget also rides the
        # wire as the gRPC timeout (server/task.py Client._call)
        dl.checkpoint("fetch_log")
        since_ts = max(since_ts, self.mvcc.base_ts)
        with tracing.span("rpc.fetch_log", peer=addr,
                          since_ts=since_ts) as sp:
            t0 = time.perf_counter()
            records, complete = self.groups.pool(addr).fetch_log(since_ts)
            METRICS.observe("rpc_latency_us",
                            (time.perf_counter() - t0) * 1e6,
                            rpc="fetch_log")
            sp.attrs["records"] = len(records)
        applied = 0
        seen_max = self.mvcc.base_ts if since_ts <= self.mvcc.base_ts \
            else 0
        for ts, kind, obj in records:
            seen_max = max(seen_max, ts)
            if kind == "schema":
                self.apply_schema_broadcast(obj, ts=ts)
                continue
            if kind == "drop":
                self.apply_drop_broadcast(ts=ts)
                continue
            if kind == "drop_attr":
                self.apply_drop_attr_broadcast(obj, ts=ts)
                continue
            if kind == "abort":
                # the origin decided ABORT for a staged ts: drop our
                # pending copy and record the decision durably so OUR
                # resolved log propagates it too
                with self._state_lock:
                    entry = self._pending.pop(ts, None)
                if entry is not None and self.wal is not None:
                    self.wal.append_decision(ts, False)
                continue
            if self.mvcc.has_applied(ts):
                continue
            with self._state_lock:
                was_pending = self._pending.pop(ts, None) is not None
            if was_pending and self.wal is not None:
                # our pend is durable; the fetched record proves the
                # origin committed it — resolve with a marker instead of
                # double-logging the payload
                self.wal.append_decision(ts, True)
                self.apply_committed(obj, ts, log_wal=False)
            else:
                self.apply_committed(obj, ts)
            applied += 1
        if applied:
            METRICS.inc("fetchlog_heals_total")
            METRICS.inc("fetchlog_records_applied_total", float(applied))
            log.info("caught up %d records > ts %d from %s",
                     applied, since_ts, addr)
        if not complete:
            # records older than the peer's WAL floor may be missing from
            # us entirely: snapshot-level resync — foreign tablets go
            # stale (re-validated on next read), owned tablets re-pull
            # from a group replica when one exists
            log.warning("peer %s WAL truncated above since_ts %d; "
                        "snapshot-level resync", addr, since_ts)
            self.mark_all_stale()
            self.resync_owned_tablets()
        return complete, seen_max

    def mark_all_stale(self) -> None:
        """Force freshness checks: every known foreign predicate must
        re-validate against its owner before serving (rejoin / deep-gap
        path)."""
        with self._state_lock:
            preds = set(self.mvcc.base.preds) | set(self.tablet_versions)
            for p in preds:
                if self.groups is None or not self.groups.serves(p):
                    self._stale_preds.add(p)
            dropped = self._pop_tablets(lambda k: True)
        for entry in dropped:
            _release_tablet(entry)

    def resync_owned_tablets(self) -> None:
        """Replace every OWNED tablet with a fresh snapshot from a group
        replica (reference: Badger Stream snapshot from the leader). A
        sole-replica group has nobody to pull from — records truncated
        out of every peer's WAL are lost for it; logged loudly (the
        reference's quorum write would have refused the commit instead)."""
        import grpc as _grpc

        from dgraph_tpu_torch.cluster.tablet import unpack_tablet
        from dgraph_tpu_torch.utils import logging as xlog
        log = xlog.get("alpha")
        replicas = [a for a in self.groups.group_addrs(self.groups.gid)
                    if a != self.groups.my_addr]
        with self._state_lock:
            known_versions = set(self.tablet_versions)
        owned = [p for p in set(self.mvcc.base.preds)
                 | known_versions if self.groups.serves(p)]
        if not replicas:
            if owned:
                log.error(
                    "no group replica to resync owned tablets %s from; "
                    "records truncated from peer WALs are unrecoverable",
                    sorted(owned))
            return
        ts = self.oracle.read_only_ts()
        for pred in owned:
            for addr in replicas:
                try:
                    blob, _v = self.groups.pool(addr).tablet_snapshot(
                        pred, ts)
                except _grpc.RpcError:
                    continue
                if blob:
                    pd = unpack_tablet(blob, pred, self.mvcc.schema)
                    self.mvcc.install_tablet(pred, pd)
                    log.info("owned tablet %s resynced from %s", pred, addr)
                break

    def resync_on_join(self, peer_addrs=None) -> None:
        """Rejoin catch-up (reference: restarted follower replaying the
        leader's log + snapshot): pull WAL tails from peers, then mark
        foreign tablets stale so reads re-validate freshness."""
        addrs = (peer_addrs if peer_addrs is not None
                 else self.groups.other_addrs())
        # fetch from our fold floor, NOT our newest layer: commits by other
        # coordinators interleave with our replayed tail, so anything above
        # the floor could be missing; has_applied() skips what we do have
        since = self.mvcc.base_ts
        for addr in addrs:
            try:
                # a peer without a covering WAL (complete=False, e.g. no
                # WAL armed or truncated past `since`) is not a source —
                # keep trying; any COMPLETE tail ends the search
                if self.catch_up(addr, since_ts=since)[0]:
                    break
            except Exception:  # noqa: BLE001 — any live peer will do
                continue
        self.mark_all_stale()

    def apply_committed(self, mut: Mutation, commit_ts: int,
                        log_wal: bool = True) -> None:
        """Install a committed mutation on THIS node: the subset of
        predicates this group serves plus the vocabulary touches. Also the
        receive path of the broadcast (WorkerService.ApplyMutation).
        `log_wal=False` when the record is already durable as a resolved
        pend+decision pair (the quorum path) — a second full copy would
        double it in FetchLog's resolved stream."""
        if self.groups is None:
            if self.wal is not None and log_wal:
                self.wal.append(mut, commit_ts)
            self.mvcc.apply(mut, commit_ts)
            return
        touched = {e[1] for e in mut.edge_sets + mut.edge_dels} | \
                  {v[1] for v in mut.val_sets + mut.val_dels}
        owned = {p for p in touched if self.groups.serves(p)}
        sub = mut.restrict(owned)
        with self._state_lock:
            for p in touched:
                self.tablet_versions[p] = max(
                    self.tablet_versions.get(p, 0), commit_ts)
                if p not in owned:
                    self._stale_preds.add(p)
        # the WAL stores the FULL record (not the owned subset): it doubles
        # as the replication log FetchLog serves to lagging peers, who need
        # every predicate to extract their own subset
        if self.wal is not None and log_wal:
            self.wal.append(mut, commit_ts)
        try:
            self.mvcc.apply(sub, commit_ts)
        except ValueError:
            # commit below a fold point (another coordinator's commit
            # raced a local rollup/alter, or catch-up recovered an old
            # record): fold it into the affected snapshots in place —
            # no data loss, reads at ts >= commit_ts see it
            from dgraph_tpu_torch.utils import logging as xlog
            xlog.get("alpha").warning(
                "absorbing straggler commit_ts %d below fold point %d",
                commit_ts, self.mvcc.base_ts)
            self.mvcc.absorb_straggler(sub, commit_ts)

    def _needs_fetch(self, pred: str, read_ts: int,
                     present_locally) -> bool:
        """Does a routed view need to pull this tablet from its owner?"""
        if self.groups is None:
            return False
        with self._state_lock:
            stale = pred in self._stale_preds
        if stale:
            return True
        return present_locally is None and not self.groups.serves(pred)

    def _pop_tablets(self, drop) -> list:
        """Remove the tablet-cache entries whose key `drop` accepts;
        the caller holds `_state_lock` and releases what is returned
        outside it (`_release_tablet`)."""
        keys = [k for k in self._tablet_cache if drop(k)]
        return [self._tablet_cache.pop(k) for k in keys]

    def _cached_tablet(self, pred: str, read_ts: int, view):
        """Fresh cached copy of a foreign tablet adapted to the current
        vocabulary, with its host, or None. Cache entries are keyed
        (pred, version) and record the vocab width + max uid at fetch:
        uid allocation is monotone, so as long as later growth appended
        ABOVE the fetch-time max uid, every rank the blob references is
        unchanged and the CSR just pads to the new width — a commit does
        not evict every cached tablet on every node. Only a mid-
        vocabulary insert (explicit low-uid write) invalidates. Each
        width's copy has its own host (the Store its kernel caches live
        on), so a request at an unchanged version and width builds and
        places nothing."""
        n = view.n_nodes
        with self._state_lock:
            version = self.tablet_versions.get(pred, 0)
            if read_ts < version:
                return None
            adapted = self._tablet_cache.get((pred, version, n))
            entry = self._tablet_cache.get((pred, version))
        if adapted is not None:
            return adapted
        if entry is None:
            return None
        pd, blob_n, last_uid, host = entry
        if n == blob_n:
            return pd, host
        if n < blob_n or int(np.searchsorted(
                view.uids, last_uid, "right")) != blob_n:
            return None  # mid-insert shifted ranks: blob unusable
        wide = self._pad_tablet(pd, blob_n, n)
        adapted = (wide, _tablet_host(pred, wide, view))
        with self._state_lock:
            # adaptations live under per-width keys; the RAW entry stays,
            # so readers at older (narrower) views keep hitting it instead
            # of refetching. Only the latest width is retained.
            dropped = self._pop_tablets(
                lambda k: k[0] == pred and len(k) == 3 and k[2] != n)
            old = self._tablet_cache.get((pred, version, n))
            if old is None:
                # graftlint: allow(split-critical-section): idempotent cache fill — concurrent fillers install equivalent adaptations for the same (pred, version, n) key, and stale widths are simply re-deleted
                self._tablet_cache[(pred, version, n)] = adapted
            else:
                adapted = old      # a concurrent filler got here first
        for e in dropped:
            _release_tablet(e)
        memgov.GOVERNOR.maybe_evict("host")
        return adapted

    @staticmethod
    def _pad_tablet(pd, old_n: int, new_n: int):
        """Extend a rank-indexed tablet to a wider (append-only-grown)
        vocabulary: CSR indptr pads with its last offset; columns and
        indexes reference only ranks < old_n and carry over unchanged."""
        from dgraph_tpu_torch.store.store import EdgeRel, PredicateData
        out = PredicateData(schema=pd.schema, vals=pd.vals,
                            index=pd.index, efacets=pd.efacets,
                            vfacets=pd.vfacets,
                            # edge POSITIONS are unchanged by widening, so
                            # the rev→fwd facet map carries over for free
                            rev_pos=pd.rev_pos)
        for side in ("fwd", "rev"):
            rel = getattr(pd, side)
            if rel is not None:
                pad = np.full(new_n - old_n, rel.indptr[-1],
                              rel.indptr.dtype)
                setattr(out, side, EdgeRel(
                    indptr=np.concatenate([rel.indptr, pad]),
                    indices=rel.indices))
        return out

    def _fetch_tablet(self, pred: str, read_ts: int, view=None):
        """Pull a foreign tablet snapshot as-of read_ts from its owning
        group (any live replica), caching latest-version pulls with
        their host (reference: Badger Stream tablet snapshot shipping).
        Returns (PredicateData, host Store) or None. The RPC runs under
        no lock."""
        gid = self.groups.tablet_owner(pred, claim=False)
        if gid is None or gid == self.groups.gid:
            return None
        if view is None:
            view = self.mvcc.read_view(read_ts)
        cached = self._cached_tablet(pred, read_ts, view)
        if cached is not None:
            return cached
        dl.checkpoint("tablet_snapshot")
        from dgraph_tpu_torch.cluster.tablet import unpack_tablet
        with tracing.span("rpc.tablet_snapshot", pred=pred,
                          read_ts=read_ts) as sp:
            t0 = time.perf_counter()
            blob, got_version = self.groups.call_group(
                gid, lambda c: c.tablet_snapshot(pred, read_ts),
                exclude=set(self._suspect_peers),
                rpc="tablet_snapshot")
            METRICS.observe("rpc_latency_us",
                            (time.perf_counter() - t0) * 1e6,
                            rpc="tablet_snapshot")
            sp.attrs["bytes"] = len(blob) if blob else 0
        if not blob:
            return None
        METRICS.inc("tablet_bytes_fetched", len(blob))
        pd = unpack_tablet(blob, pred, self.mvcc.schema)
        host = _tablet_host(pred, pd, view)
        with self._state_lock:
            version = self.tablet_versions.get(pred, 0)
            # trust the OWNER's version: a broadcast still in flight (or
            # dropped) may have produced a blob newer than we knew — such
            # a blob must not be cached under the stale local version or
            # an older-ts reader would see future writes
            version = max(version, got_version)
            self.tablet_versions[pred] = max(
                self.tablet_versions.get(pred, 0), got_version)
            dropped = []
            if read_ts >= version:
                dropped = self._pop_tablets(
                    lambda k: k[0] == pred and (k[1] != version
                                                or len(k) == 2))
                self._tablet_cache[(pred, version)] = (
                    pd, view.n_nodes, int(view.uids[-1])
                    if view.n_nodes else 0, host)
        for e in dropped:
            _release_tablet(e)
        memgov.GOVERNOR.maybe_evict("host")
        return pd, host

    def remote_hop(self, pred: str, reverse: bool, frontier,
                   read_ts: int, view):
        """One-hop expansion executed on the tablet's OWNER via ServeTask
        (frontier uids in, UidMatrix out) — O(frontier + result) bytes on
        the wire instead of the whole tablet (reference: worker/task.go
        ProcessTaskOverNetwork, the per-hop mechanism). Used when no
        fresh local copy exists and the frontier is small; large
        frontiers amortize a whole-tablet pull instead. Returns
        (nbrs_ranks, seg, empty_pos) or None when ineligible."""
        if self.groups is None or len(frontier) > self.remote_hop_max:
            return None
        dl.checkpoint("serve_task")
        gid = self.groups.tablet_owner(pred, claim=False)
        if gid is None or gid == self.groups.gid:
            return None
        if self._cached_tablet(pred, read_ts, view) is not None:
            return None  # fresh cached copy: zero transfer beats an RPC
        if dict.__contains__(view.preds, pred) and \
                not self._needs_fetch(pred, read_ts, True):
            # locally present and fresh (e.g. the tablet just moved away
            # from this node): serve from memory, skip the RPC
            return None
        uids = view.uid_of(np.asarray(frontier, np.int32)).astype(
            np.uint64)
        import grpc as _grpc
        with tracing.span("rpc.serve_task", pred=pred,
                          frontier=int(len(uids))):
            t0 = time.perf_counter()
            try:
                res = self.groups.call_group(
                    gid, lambda c: c.serve_task(
                        attr=pred, reverse=reverse,
                        frontier={"uids": uids.tolist()},
                        read_ts=read_ts),
                    exclude=set(self._suspect_peers),
                    rpc="serve_task")
            except _grpc.RpcError:
                # every replica of the owning group refused the per-hop
                # leg: fall back to the whole-tablet pull (its own
                # failover path; exhausted there → ReadUnavailable)
                # instead of failing the query on a routing shortcut
                METRICS.inc("taskhop_to_pull_total")
                return None
            METRICS.observe("rpc_latency_us",
                            (time.perf_counter() - t0) * 1e6,
                            rpc="serve_task")
        nbrs_parts, seg_parts = [], []
        total_uids = 0
        for i, row in enumerate(res.matrix.rows):
            if not row.uids:
                continue
            ranks = view.rank_of(np.array(row.uids, np.int64))
            ranks = ranks[ranks >= 0]
            nbrs_parts.append(ranks.astype(np.int32))
            seg_parts.append(np.full(len(ranks), i, np.int32))
            total_uids += len(ranks)
        METRICS.inc("taskhop_bytes_fetched",
                    8 * (len(uids) + total_uids))
        if not nbrs_parts:
            e = np.zeros(0, np.int32)
            return e, e, np.zeros(0, np.int64)
        return (np.concatenate(nbrs_parts), np.concatenate(seg_parts),
                np.zeros(0, np.int64))

    def apply_schema_broadcast(self, schema_text: str,
                               ts: int = 0) -> int:
        """Receive/apply an Alter (no re-broadcast). Returns its ts."""
        new = parse_schema(schema_text)
        with self._apply_lock:
            ts = ts or self.oracle.read_only_ts()
            merged = self.mvcc.schema.clone()
            merged.update(new)
            if self.wal is not None:
                self.wal.append_schema(schema_text, ts)
            self.mvcc.rebuild_base(schema=merged)
        return ts

    def _txn_done(self, txn: "Txn") -> None:
        with self._state_lock:
            self._open_txns.pop(txn.start_ts, None)

    def report_tablet_sizes(self) -> dict[str, int]:
        """Report owned-tablet sizes to Zero (reference: the tablet-size
        heartbeat feeding zero/tablet.go's rebalance loop)."""
        store = self.mvcc.read_view(self.oracle.read_only_ts())
        sizes: dict[str, int] = {}
        hints = getattr(store.preds, "size_hints", None)
        if hints is not None:
            # out-of-core base: manifest byte sizes, no faulting — the
            # heartbeat must never page the whole store in
            sizes = {p: nb for p, nb in hints().items()
                     if self.groups.serves(p)}
            self.groups.zero.report_tablets(self.groups.gid, sizes)
            return sizes
        for pred, pd in store.preds.items():
            if not self.groups.serves(pred):
                continue
            n = 0
            for rel in (pd.fwd, pd.rev):
                if rel is not None:
                    n += rel.indptr.nbytes + rel.indices.nbytes
            for col in pd.vals.values():
                n += col.subj.nbytes
                if col.vals.dtype == object:
                    # sampled estimate: exact byte counts would re-scan
                    # millions of strings every heartbeat
                    k = min(len(col.vals), 256)
                    if k:
                        avg = sum(len(str(v))
                                  for v in col.vals[:k]) / k
                        n += int(avg * len(col.vals))
                else:
                    n += col.vals.nbytes
            sizes[pred] = n
        self.groups.zero.report_tablets(self.groups.gid, sizes)
        return sizes

    def report_health(self) -> dict:
        """Ship this node's peer-health view (/debug/peers data: breaker
        states + EMA latencies, cluster/resilience.py) and its per-tablet
        cost sums (utils/costprofile.py) to Zero — the placement signal
        that lets tablet moves prefer healthy, under-loaded peers and
        never target half-open/dead ones (cluster/zero.py
        report_health / move_tablet)."""
        peers = self.groups.peer_health()
        doc = {"node_id": self.groups.node_id,
               "group": self.groups.gid,
               "addr": self.groups.my_addr,
               "peers": peers,
               "tablet_costs": {
                   p: c for p, c in costprofile.tablet_costs().items()
                   # claim=False: a cost key must never CLAIM a tablet
                   # (the overflow key "other" is not even a predicate)
                   if self.groups.tablet_owner(p, claim=False)
                   == self.groups.gid}}
        self.groups.zero.report_health(doc)
        return doc

    def _heal_corrupt_tablet(self, pred: str):
        """Pull a fresh copy of an OWNED tablet from a group replica
        after its on-disk segments failed an integrity check — the
        disk-side twin of the FetchLog heal. Iterates replicas in
        PeerTable order (open breakers fail fast); returns the unpacked
        PredicateData or None when no replica can serve it (the caller
        then raises the original StorageCorruption)."""
        if self.groups is None:
            return None
        import grpc as _grpc

        from dgraph_tpu_torch.cluster.tablet import unpack_tablet
        from dgraph_tpu_torch.utils import logging as xlog
        replicas = [a for a in self.groups.group_addrs(self.groups.gid)
                    if a != self.groups.my_addr]
        for addr in replicas:
            try:
                blob, _v = self.groups.pool(addr).tablet_snapshot(
                    pred, self.mvcc.base_ts)
            except _grpc.RpcError:
                continue
            if blob:
                xlog.get("alpha").warning(
                    "healed corrupt tablet %s from replica %s "
                    "(on-disk copy rewrites at the next checkpoint)",
                    pred, addr)
                flightrec.emit("storage.heal", pred=pred, replica=addr)
                return unpack_tablet(blob, pred, self.mvcc.schema)
        return None

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
