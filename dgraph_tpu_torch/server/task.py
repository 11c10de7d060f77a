"""gRPC services: the public Dgraph API and the Worker task seam.

Port of `dgraph_tpu/server/task.py`: `DgraphService`, `WorkerService`,
`make_server` and `Client`. The method paths are the reference's strings
(`dgraph_tpu.Dgraph`, `dgraph_tpu.Worker`) and the messages the port's
own copy of the reference's (`protos/task_pb2.py`), so a port node and a
reference node serve each other. `ServeTask` expands a hop through the
port's `Executor` on the node's device: a frontier of at least
`device_threshold` rows runs on the card. The flight recorder's
`DebugFlight` and its in-flight RPC legs come with ROADMAP Queue 1
item 9f.

Reference parity: `worker/server.go` (grpc `pb.Worker` service —
`ServeTask` is the boundary the north star names: an Alpha offloads
per-hop expansion to this service) and `edgraph/server.go` exposed as the
public `api.Dgraph` service (Query/Mutate/Alter/CommitOrAbort).

grpc-python service stubs normally come from grpcio-tools, which this
image lacks; services are registered through grpc's generic-handler API
against the protoc-generated messages instead — same wire behavior,
no codegen dependency.
"""

from __future__ import annotations

import time
from concurrent import futures

import grpc
import numpy as np

from dgraph_tpu_torch.engine.execute import Executor
from dgraph_tpu_torch.protos import task_pb2 as pb
from dgraph_tpu_torch.server.admission import ServerOverloaded
from dgraph_tpu_torch.server.api import (Alpha, NoQuorum, ReadUnavailable,
                                   StageRefused, TxnAborted)
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import tracing

SERVICE_DGRAPH = "dgraph_tpu.Dgraph"
SERVICE_WORKER = "dgraph_tpu.Worker"

# gRPC metadata keys the ambient trace context rides on — forwarded by
# Client._attempt exactly the way the remaining deadline budget rides
# the gRPC timeout, re-established by every worker-side handler via
# _inbound_trace so a cross-group hop produces ONE trace whose worker
# spans are genuine children of the coordinator's request trace
TRACE_ID_MD = "x-dgraph-trace-id"
PARENT_SPAN_MD = "x-dgraph-parent-span"


def _inbound_trace(ctx):
    """Re-establish the caller's trace context from gRPC metadata (the
    budget-forwarding pattern applied to trace identity). Returns a
    context manager; no metadata = no-op."""
    if ctx is None:
        return tracing.attach("")
    md = {k.lower(): v for k, v in (ctx.invocation_metadata() or ())}
    tid = md.get(TRACE_ID_MD, "")
    try:
        parent = int(md.get(PARENT_SPAN_MD) or 0)
    except ValueError:
        parent = 0
    return tracing.attach(tid, parent)

# read-shaped worker RPCs whose outbound calls FORWARD the remaining
# request budget as the gRPC timeout (the Go context-propagation
# analog). Mutation-protocol legs (ApplyMutation/ApplyDecision) are
# deliberately absent: once two-phase staging starts the decision
# protocol must run to completion — a budget interrupt between stage
# and decide would leak an undecided pend.
_BUDGET_FORWARDED = {"ServeTask", "FetchLog", "TabletSnapshot",
                     "ChainHead", "Query", "DebugTraces", "DebugFleet"}

# worker RPCs the resilience layer may RE-ATTEMPT on a transport
# failure (cluster/resilience.py). Every receive path is idempotent —
# re-staging/re-applying a ts the peer already logged is a no-op — so
# the whole worker surface is safe to retry; the retry policy itself
# refuses non-transport failures (DEADLINE_EXCEEDED, app errors).
_RETRYABLE_RPCS = {"ServeTask", "Ping", "ChainHead", "ApplyMutation",
                   "ApplyDecision", "FetchLog", "DebugTraces",
                   "DebugFleet", "PullTablet", "TabletSnapshot"}


# a whole-tablet snapshot at SF1 (TabletSnapshot, PullTablet) is tens of
# MiB: past gRPC's 4 MiB default receive limit, which the reference
# keeps. The port's channels and servers lift both limits; the bytes of
# every message stay the reference's.
GRPC_OPTIONS = (("grpc.max_receive_message_length", -1),
                ("grpc.max_send_message_length", -1))


def _grpc_deadline_ms(ctx) -> float | None:
    """Re-establish a request budget from the inbound gRPC deadline
    (reference: the server-side context.Context carrying the caller's
    deadline). Tolerates a missing context (tests drive handlers
    directly)."""
    rem = ctx.time_remaining() if ctx is not None else None
    return None if rem is None else max(rem, 0.0) * 1e3


class DgraphService:
    """Public API service (api.Dgraph analog)."""

    def __init__(self, alpha: Alpha):
        self.alpha = alpha

    def _acl_user(self, ctx):
        """Token gate for the public service when ACL is on (reference:
        the accessJwt gRPC metadata every dgo client attaches). The
        WORKER service stays cluster-internal — peers authenticate by
        network placement, as the reference's worker port does."""
        if self.alpha.acl is None:
            return None
        md = {k.lower(): v for k, v in (ctx.invocation_metadata() or ())}
        token = md.get("accessjwt") or md.get("x-dgraph-accesstoken")
        try:
            return self.alpha.acl.verify(token)
        except PermissionError as e:
            ctx.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))

    def Query(self, req: pb.Request, ctx) -> pb.Response:
        t0 = time.perf_counter()
        acl_user = self._acl_user(ctx)
        start_ts = req.start_ts or None
        try:
            raw = self.alpha.query_raw(req.query, dict(req.vars) or None,
                                       read_ts=start_ts,
                                       acl_user=acl_user,
                                       deadline_ms=_grpc_deadline_ms(ctx))
        except ReadUnavailable as e:
            # retryable by contract: the replica cannot verify its
            # snapshot is gap-free (partitioned) — same code the
            # reference maps unreachable-quorum reads onto
            ctx.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except dl.DeadlineExceeded as e:
            ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except dl.Cancelled as e:
            ctx.abort(grpc.StatusCode.CANCELLED, str(e))
        except ServerOverloaded as e:
            # RESOURCE_EXHAUSTED is gRPC's retryable overload code; the
            # retry-after hint rides the message (HTTP carries it as a
            # real Retry-After header)
            ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        return pb.Response(
            json=raw,
            txn=pb.TxnContext(start_ts=start_ts or 0),
            latency_us=int((time.perf_counter() - t0) * 1e6))

    def Mutate(self, req: pb.MutationReq, ctx) -> pb.MutationResp:
        acl_user = self._acl_user(ctx)
        try:
            res = self.alpha.mutate(
                set_nquads=req.set_nquads or None,
                del_nquads=req.del_nquads or None,
                set_json=req.set_json or None,
                del_json=req.del_json or None,
                commit_now=req.commit_now,
                start_ts=req.start_ts or None,
                acl_user=acl_user,
                deadline_ms=_grpc_deadline_ms(ctx))
        except TxnAborted as e:
            ctx.abort(grpc.StatusCode.ABORTED, str(e))
        except NoQuorum as e:
            # UNAVAILABLE, not ABORTED: the txn did not lose a conflict —
            # the replica group cannot commit right now (minority side)
            ctx.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except dl.DeadlineExceeded as e:
            ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except dl.Cancelled as e:
            ctx.abort(grpc.StatusCode.CANCELLED, str(e))
        except ServerOverloaded as e:
            ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except PermissionError as e:
            ctx.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        return pb.MutationResp(
            uids=res["uids"],
            txn=pb.TxnContext(start_ts=res["txn"]["start_ts"],
                              commit_ts=res["txn"]["commit_ts"]))

    def CommitOrAbort(self, req: pb.TxnContext, ctx) -> pb.TxnContext:
        try:
            cts = self.alpha.commit_or_abort(
                req.start_ts, abort=req.aborted,
                deadline_ms=_grpc_deadline_ms(ctx))
        except TxnAborted as e:
            ctx.abort(grpc.StatusCode.ABORTED, str(e))
        except NoQuorum as e:
            ctx.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except dl.DeadlineExceeded as e:
            ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except ServerOverloaded as e:
            ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        return pb.TxnContext(start_ts=req.start_ts, commit_ts=cts,
                             aborted=req.aborted)

    def Alter(self, req: pb.Operation, ctx) -> pb.Payload:
        acl_user = self._acl_user(ctx)
        if self.alpha.acl is not None:
            try:
                self.alpha.acl.check_alter(acl_user)
            except PermissionError as e:
                ctx.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        if req.drop_all:
            self.alpha.drop_all()
        elif req.drop_attr:
            self.alpha.drop_attr(req.drop_attr)
        elif req.schema:
            self.alpha.alter(req.schema)
        return pb.Payload(data=b"ok")

    def AssignUids(self, req: pb.AssignRequest, ctx) -> pb.AssignedIds:
        r = self.alpha.oracle.assign_uids(int(req.num))
        return pb.AssignedIds(start_id=r.start, end_id=r.stop - 1)


class WorkerService:
    """The task seam: one-hop expansion requests (worker.ServeTask)."""

    def __init__(self, alpha: Alpha):
        self.alpha = alpha

    def ServeTask(self, req: pb.TaskQuery, ctx) -> pb.TaskResult:
        # one-shot read: read_only_ts never registers a pending txn (a
        # leaked read_ts would pin the oracle gc watermark forever), and
        # _reading keeps gc from dropping the snapshot mid-task. The
        # caller's remaining budget (gRPC deadline) becomes THIS node's
        # request context, so a forwarded hop keeps checkpointing —
        # context propagation, as the reference's ctx crosses
        # ProcessTaskOverNetwork. The caller's trace context rides the
        # same metadata (_inbound_trace), so this handler's spans are
        # genuine children of the coordinator's request trace — one
        # trace end to end, with no ?peer= proxying.
        try:
            with dl.activate(dl.RequestContext(_grpc_deadline_ms(ctx))), \
                    _inbound_trace(ctx):
                with tracing.span("worker.serve_task", attr=req.attr,
                                  frontier=len(req.frontier.uids)):
                    with self.alpha._reading(
                            int(req.read_ts) or None) as ts:
                        return self._serve(req, ts)
        except dl.DeadlineExceeded as e:
            ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))

    def _serve(self, req: pb.TaskQuery, ts: int) -> pb.TaskResult:
        store = self.alpha.mvcc.read_view(ts)
        ex = Executor(store, device=self.alpha.device,
                      device_threshold=self.alpha.device_threshold)
        if req.func_name:
            from dgraph_tpu_torch.engine.ir import FuncNode
            from dgraph_tpu_torch.engine.funcs import eval_func
            ranks = eval_func(store, FuncNode(
                name=req.func_name, attr=req.attr,
                args=list(req.func_args), lang=req.lang))
            flat_uids = store.uid_of(ranks).astype(np.uint64)
            return pb.TaskResult(
                flat=pb.UidList(uids=flat_uids.tolist()))
        frontier_uids = np.array(list(req.frontier.uids), np.int64)
        ranks = store.rank_of(frontier_uids)
        known = ranks >= 0
        nbrs, seg, _pos = ex.expand(req.attr, req.reverse,
                                    ranks[known].astype(np.int32))
        rows = []
        kept_pos = np.nonzero(known)[0]
        for i in range(len(frontier_uids)):
            rows.append(pb.UidList())
        if len(nbrs):
            order = np.argsort(seg, kind="stable")
            nbrs, seg = nbrs[order], seg[order]
            bounds = np.searchsorted(seg, np.arange(len(kept_pos) + 1))
            for local, pos in enumerate(kept_pos):
                lo, hi = bounds[local], bounds[local + 1]
                row = nbrs[lo:hi]
                if req.offset:
                    row = row[req.offset:]
                if req.first:
                    row = row[:req.first]
                rows[pos] = pb.UidList(
                    uids=store.uid_of(row).astype(np.uint64).tolist())
        flat = (np.unique(nbrs) if len(nbrs)
                else np.zeros(0, np.int32))
        return pb.TaskResult(
            matrix=pb.UidMatrix(rows=rows),
            flat=pb.UidList(
                uids=store.uid_of(flat).astype(np.uint64).tolist()),
            edges_traversed=int(len(nbrs)))

    # -- cluster seams (worker/draft.go apply + snapshot shipping) ----------
    def Ping(self, req: pb.Empty, ctx) -> pb.Payload:
        """Liveness probe for commit-quorum pre-flight (raft heartbeat
        analog, pull-shaped)."""
        return pb.Payload(data=b"ok")

    def ChainHead(self, req: pb.Empty, ctx) -> pb.AssignedIds:
        """Chain-head probe for the partition-safe read gate: (node id,
        last ts this node broadcast). The reader compares the head
        against what it last APPLIED from this node and pulls any gap
        via FetchLog before serving (api.Alpha._verify_read_chains).
        Reuses AssignedIds (start_id=node, end_id=head) — no proto
        regen needed for two uint64s."""
        with _inbound_trace(ctx):
            a = self.alpha
            nid = a.groups.node_id if a.groups is not None else 0
            return pb.AssignedIds(start_id=nid, end_id=a._last_sent_ts)

    def ApplyMutation(self, req: pb.MutationMsg, ctx) -> pb.Payload:
        """Receive a broadcast (log shipping) — mutation, Alter, or
        DropAll, all riding one chain. Chained origin/prev_ts trigger gap
        catch-up BEFORE applying (the ack then certifies the receiver
        converged through this record's ts)."""
        from dgraph_tpu_torch.store.wal import mut_from_bytes
        with _inbound_trace(ctx):
            if req.stage:
                # commit-quorum phase 1: durably log as pending, no
                # apply; the ack is the durability certificate (raft
                # AppendEntries)
                try:
                    self.alpha.receive_stage(
                        mut_from_bytes(req.mut_json), int(req.commit_ts),
                        int(req.origin), int(req.prev_ts))
                except StageRefused as e:
                    # no armed WAL: the ack would be a durability lie —
                    # the coordinator must not count this node toward
                    # majority
                    ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              str(e))
                return pb.Payload(data=b"ok")
            if req.drop_all:
                kind, obj = "drop", None
            elif req.drop_attr:
                kind, obj = "drop_attr", req.drop_attr
            elif req.schema:
                kind, obj = "schema", req.schema
            else:
                kind, obj = "mut", mut_from_bytes(req.mut_json)
            self.alpha.receive_broadcast(kind, obj, int(req.commit_ts),
                                         int(req.origin),
                                         int(req.prev_ts))
            return pb.Payload(data=b"ok")

    def ApplyDecision(self, req: pb.DecisionMsg, ctx) -> pb.Payload:
        """Commit-quorum phase 2: resolve a staged ts (apply on commit,
        drop on abort). Idempotent; unknown ts already resolved by
        catch-up."""
        with _inbound_trace(ctx):
            self.alpha.receive_decision(int(req.commit_ts),
                                        bool(req.commit),
                                        int(req.origin))
            return pb.Payload(data=b"ok")

    def FetchLog(self, req: pb.FetchLogRequest, ctx) -> pb.LogRecords:
        """Serve the local WAL tail above since_ts (reference: raft log
        replay to a lagging follower / Badger Stream). Records are FULL
        mutations (apply_committed logs them unrestricted), so any peer
        can extract its own subset."""
        from dgraph_tpu_torch.store.wal import mut_to_bytes, resolved_replay
        since = int(req.since_ts)
        with _inbound_trace(ctx), \
                tracing.span("worker.fetch_log", since_ts=since) as sp:
            out = pb.LogRecords(complete=since >= self.alpha._wal_floor)
            if self.alpha.wal is None:
                out.complete = False
                return out
            # resolved stream: pend+dec pairs surface as committed muts
            # or abort markers; unresolved pends never leave this node
            for ts, kind, obj in resolved_replay(self.alpha.wal.path):
                if ts <= since:
                    continue
                if kind == "mut":
                    out.records.append(pb.LogRecord(
                        ts=ts, mut_json=mut_to_bytes(obj)))
                elif kind == "abort":
                    out.records.append(pb.LogRecord(ts=ts, abort=True))
                elif kind == "schema":
                    out.records.append(pb.LogRecord(ts=ts, schema=obj))
                elif kind == "drop_attr":
                    out.records.append(pb.LogRecord(ts=ts,
                                                    drop_attr=obj))
                else:
                    out.records.append(pb.LogRecord(ts=ts, drop=True))
            sp.attrs["records"] = len(out.records)
            return out

    def DebugTraces(self, req: pb.Operation, ctx) -> pb.Payload:
        """Serve this node's span registry over the worker transport so
        the HTTP debug surface of ANY node can pull peer-leg spans
        (/debug/traces?peer= — ROADMAP observability follow-on).
        Reuses Operation (schema=trace_id, drop_attr=max-n) the way
        ChainHead reuses AssignedIds — no proto regen for two strings;
        the payload is the span-dict JSON /debug/traces already
        serves."""
        import json as _json
        with _inbound_trace(ctx):
            tid = req.schema
            if tid:
                spans = tracing.trace_spans(tid)
            else:
                spans = tracing.recent(int(req.drop_attr or 256))
            return pb.Payload(data=_json.dumps(
                [s.to_dict() for s in spans]).encode())

    def DebugFleet(self, req: pb.Operation, ctx) -> pb.Payload:
        """Serve this node's fleet fragment (server/fleet.py
        node_snapshot: identity, instance metrics exposition, cost-
        digest state, breaker states, watchdog status, race/lock-gate
        counts) over the worker transport — the per-node leg
        GET /debug/fleet fans out on. Reuses Operation → Payload the
        way DebugTraces does; the caller's remaining budget rides as
        the gRPC deadline, so a fleet fan-out never waits on a slow
        peer past its budget."""
        import json as _json
        from dgraph_tpu_torch.server import fleet
        with dl.activate(dl.RequestContext(_grpc_deadline_ms(ctx))), \
                _inbound_trace(ctx):
            doc = fleet.node_snapshot(self.alpha)
        return pb.Payload(data=_json.dumps(doc, default=str).encode())

    def PullTablet(self, req: pb.PullTabletRequest, ctx) -> pb.Payload:
        """Pull a whole tablet from a peer and install it locally — the
        data-ship leg of a tablet move (reference: movePredicate's Badger
        Stream from the old owner to the new). Committed layers above the
        snapshot compose on top, so writes racing the move survive."""
        from dgraph_tpu_torch.cluster.tablet import unpack_tablet
        with _inbound_trace(ctx):
            src = Client(req.src_addr)
            try:
                blob, version = src.tablet_snapshot(
                    req.attr, self.alpha.oracle.read_only_ts())
            finally:
                src.close()
            if blob:
                pd = unpack_tablet(blob, req.attr,
                                   self.alpha.mvcc.schema)
                self.alpha.mvcc.install_tablet(req.attr, pd)
                with self.alpha._state_lock:
                    self.alpha.tablet_versions[req.attr] = max(
                        self.alpha.tablet_versions.get(req.attr, 0),
                        version)
                    self.alpha._stale_preds.discard(req.attr)
            return pb.Payload(data=b"ok")

    def TabletSnapshot(self, req: pb.TabletSnapshotRequest,
                       ctx) -> pb.TabletSnapshot:
        """Serve a whole-tablet snapshot as-of read_ts (reference: Badger
        Stream snapshot / tablet move source)."""
        from dgraph_tpu_torch.cluster.tablet import pack_tablet
        with _inbound_trace(ctx), \
                tracing.span("worker.tablet_snapshot",
                             attr=req.attr) as sp:
            with self.alpha._reading(int(req.read_ts) or None) as ts:
                store = self.alpha.mvcc.read_view(ts)
                pd = store.preds.get(req.attr)
                version = self.alpha.tablet_versions.get(req.attr, 0)
                if pd is None:
                    return pb.TabletSnapshot(blob=b"", version=version)
                blob = pack_tablet(pd)
                sp.attrs["bytes"] = len(blob)
                return pb.TabletSnapshot(blob=blob, version=version)


def _unary(fn, req_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=lambda m: m.SerializeToString())


def make_server(alpha: Alpha, addr: str = "127.0.0.1:0",
                max_workers: int = 8):
    """Build (grpc server, bound port). Reference: worker/server.go
    grpc setup in alpha run()."""
    d, w = DgraphService(alpha), WorkerService(alpha)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=GRPC_OPTIONS)
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(SERVICE_DGRAPH, {
            "Query": _unary(d.Query, pb.Request),
            "Mutate": _unary(d.Mutate, pb.MutationReq),
            "Alter": _unary(d.Alter, pb.Operation),
            "CommitOrAbort": _unary(d.CommitOrAbort, pb.TxnContext),
            "AssignUids": _unary(d.AssignUids, pb.AssignRequest),
        }),
        grpc.method_handlers_generic_handler(SERVICE_WORKER, {
            "ServeTask": _unary(w.ServeTask, pb.TaskQuery),
            "Ping": _unary(w.Ping, pb.Empty),
            "ChainHead": _unary(w.ChainHead, pb.Empty),
            "ApplyMutation": _unary(w.ApplyMutation, pb.MutationMsg),
            "ApplyDecision": _unary(w.ApplyDecision, pb.DecisionMsg),
            "FetchLog": _unary(w.FetchLog, pb.FetchLogRequest),
            "DebugTraces": _unary(w.DebugTraces, pb.Operation),
            "DebugFleet": _unary(w.DebugFleet, pb.Operation),
            "PullTablet": _unary(w.PullTablet, pb.PullTabletRequest),
            "TabletSnapshot": _unary(w.TabletSnapshot,
                                     pb.TabletSnapshotRequest),
        }),
    ))
    port = server.add_insecure_port(addr)
    return server, port


class Client:
    """Minimal client over the same generic method paths (dgo analog).

    Pooled cluster clients (cluster/groups.py) carry a shared
    `resilience` PeerTable: every call then runs under that node's
    per-peer circuit breaker + budget-aware retry policy
    (cluster/resilience.py). Ad-hoc clients (tests, debug proxies,
    PullTablet's one-shot source dial) keep the historical
    single-attempt behavior. `fault_check` is the fault-injection
    hook (cluster/fault.py) — invoked before EVERY wire attempt so an
    injected LinkDown exercises the same retry/breaker path a real
    connect failure does."""

    def __init__(self, target: str, resilience=None,
                 peer_addr: str | None = None):
        self.channel = grpc.insecure_channel(target, options=GRPC_OPTIONS)
        self.resilience = resilience
        self.peer_addr = peer_addr or target
        self.fault_check = None

    def _call(self, service: str, method: str, req, resp_cls):
        from dgraph_tpu_torch.utils import costprofile
        costprofile.add("rpc_legs", 1)
        rpc = self.channel.unary_unary(
            f"/{service}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        if self.resilience is not None:
            return self.resilience.call(
                self.peer_addr, method,
                lambda: self._attempt(rpc, method, req),
                retryable=method in _RETRYABLE_RPCS)
        return self._attempt(rpc, method, req)

    def _attempt(self, rpc, method: str, req):
        """One wire attempt, with fault injection, budget forwarding,
        and trace propagation: a read-shaped leg inside an active
        request context carries the REMAINING budget as its gRPC
        timeout, so a peer never works past what the client will wait
        for, and the ambient trace context (trace id + innermost open
        span id) rides as metadata so the peer's handler spans join
        THIS request's trace. An expired budget refuses before the
        wire; a deadline that fires mid-call surfaces as
        DeadlineExceeded (ours), NOT RpcError — the peer is alive, OUR
        budget died, and callers (and the retry policy) must not
        mistake that for an unreachable replica."""
        kw = {}
        tid = tracing.current_trace_id()
        if tid and tracing.enabled():
            kw["metadata"] = ((TRACE_ID_MD, tid),
                              (PARENT_SPAN_MD,
                               str(tracing.current_span_id())))
        if self.fault_check is not None:
            self.fault_check()
        if method in _BUDGET_FORWARDED:
            ctx = dl.current()
            if ctx is not None:
                rem = ctx.remaining_s()
                if rem is not None:
                    ctx.check(f"rpc.{method}")
                    try:
                        return rpc(req, timeout=rem, **kw)
                    except grpc.RpcError as e:
                        code = (e.code() if hasattr(e, "code")
                                else None)
                        if code == \
                                grpc.StatusCode.DEADLINE_EXCEEDED:
                            ctx.check(f"rpc.{method}")  # raises if dead
                            from dgraph_tpu_torch.utils.metrics import \
                                METRICS
                            METRICS.inc("deadline_exceeded_total",
                                        stage=f"rpc.{method}")
                            raise dl.DeadlineExceeded(
                                f"budget expired inside {method} "
                                f"RPC",
                                stage=f"rpc.{method}") from e
                        raise
        return rpc(req, **kw)

    def query(self, dql: str, start_ts: int = 0) -> dict:
        import json
        resp = self._call(SERVICE_DGRAPH, "Query",
                          pb.Request(query=dql, start_ts=start_ts),
                          pb.Response)
        return json.loads(resp.json)

    def mutate(self, **kw) -> pb.MutationResp:
        return self._call(SERVICE_DGRAPH, "Mutate",
                          pb.MutationReq(**kw), pb.MutationResp)

    def alter(self, schema: str = "", drop_all: bool = False,
              drop_attr: str = "") -> None:
        self._call(SERVICE_DGRAPH, "Alter",
                   pb.Operation(schema=schema, drop_all=drop_all,
                                drop_attr=drop_attr),
                   pb.Payload)

    def commit_or_abort(self, start_ts: int,
                        abort: bool = False) -> pb.TxnContext:
        return self._call(SERVICE_DGRAPH, "CommitOrAbort",
                          pb.TxnContext(start_ts=start_ts, aborted=abort),
                          pb.TxnContext)

    def serve_task(self, **kw) -> pb.TaskResult:
        return self._call(SERVICE_WORKER, "ServeTask",
                          pb.TaskQuery(**kw), pb.TaskResult)

    def apply_mutation(self, mut_json: bytes, commit_ts: int,
                       origin: int = 0, prev_ts: int = 0,
                       stage: bool = False) -> None:
        self._call(SERVICE_WORKER, "ApplyMutation",
                   pb.MutationMsg(mut_json=mut_json, commit_ts=commit_ts,
                                  origin=origin, prev_ts=prev_ts,
                                  stage=stage),
                   pb.Payload)

    def ping(self) -> None:
        self._call(SERVICE_WORKER, "Ping", pb.Empty(), pb.Payload)

    def chain_head(self) -> tuple[int, int]:
        """(node_id, last broadcast ts) of the peer — read-gate probe."""
        r = self._call(SERVICE_WORKER, "ChainHead", pb.Empty(),
                       pb.AssignedIds)
        return int(r.start_id), int(r.end_id)

    def apply_decision(self, commit_ts: int, commit: bool,
                       origin: int = 0) -> None:
        self._call(SERVICE_WORKER, "ApplyDecision",
                   pb.DecisionMsg(commit_ts=commit_ts, commit=commit,
                                  origin=origin),
                   pb.Payload)

    def debug_traces(self, trace_id: str = "", n: int = 256) -> list:
        """Pull the peer's span registry (DebugTraces RPC): span dicts,
        one trace's spans when trace_id is given, else the recent ring."""
        import json as _json
        r = self._call(SERVICE_WORKER, "DebugTraces",
                       pb.Operation(schema=trace_id, drop_attr=str(n)),
                       pb.Payload)
        return _json.loads(bytes(r.data).decode())

    def debug_fleet(self) -> dict:
        """Pull the peer's fleet fragment (DebugFleet RPC): identity,
        metrics exposition, cost-digest state, breaker states,
        watchdog status, gate counts — one node's slice of
        /debug/fleet."""
        import json as _json
        r = self._call(SERVICE_WORKER, "DebugFleet", pb.Operation(),
                       pb.Payload)
        return _json.loads(bytes(r.data).decode())

    def fetch_log(self, since_ts: int):
        """Returns ([(ts, kind, obj)...], complete) mirroring wal.replay."""
        from dgraph_tpu_torch.store.wal import mut_from_bytes
        r = self._call(SERVICE_WORKER, "FetchLog",
                       pb.FetchLogRequest(since_ts=since_ts), pb.LogRecords)
        out = []
        for rec in r.records:
            if rec.abort:
                out.append((int(rec.ts), "abort", None))
            elif rec.drop:
                out.append((int(rec.ts), "drop", None))
            elif rec.drop_attr:
                out.append((int(rec.ts), "drop_attr", rec.drop_attr))
            elif rec.schema:
                out.append((int(rec.ts), "schema", rec.schema))
            else:
                out.append((int(rec.ts), "mut",
                            mut_from_bytes(rec.mut_json)))
        return out, bool(r.complete)

    def apply_schema(self, schema_text: str, ts: int = 0, origin: int = 0,
                     prev_ts: int = 0) -> None:
        self._call(SERVICE_WORKER, "ApplyMutation",
                   pb.MutationMsg(schema=schema_text, commit_ts=ts,
                                  origin=origin, prev_ts=prev_ts),
                   pb.Payload)

    def apply_drop(self, ts: int = 0, origin: int = 0,
                   prev_ts: int = 0) -> None:
        self._call(SERVICE_WORKER, "ApplyMutation",
                   pb.MutationMsg(drop_all=True, commit_ts=ts,
                                  origin=origin, prev_ts=prev_ts),
                   pb.Payload)

    def apply_drop_attr(self, pred: str, ts: int = 0, origin: int = 0,
                        prev_ts: int = 0) -> None:
        self._call(SERVICE_WORKER, "ApplyMutation",
                   pb.MutationMsg(drop_attr=pred, commit_ts=ts,
                                  origin=origin, prev_ts=prev_ts),
                   pb.Payload)

    def pull_tablet(self, attr: str, src_addr: str) -> None:
        self._call(SERVICE_WORKER, "PullTablet",
                   pb.PullTabletRequest(attr=attr, src_addr=src_addr),
                   pb.Payload)

    def tablet_snapshot(self, attr: str, read_ts: int = 0):
        r = self._call(SERVICE_WORKER, "TabletSnapshot",
                       pb.TabletSnapshotRequest(attr=attr, read_ts=read_ts),
                       pb.TabletSnapshot)
        return bytes(r.blob), int(r.version)

    def close(self):
        self.channel.close()
