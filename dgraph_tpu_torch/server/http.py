"""HTTP API: an Alpha's REST surface.

Port of `dgraph_tpu/server/http.py`. Reference parity:
`dgraph/cmd/alpha/run.go` HTTP handlers — POST /query, /query/batch,
/mutate, /commit, /alter, /login and the /admin triggers; GET /health,
/state (the topology document: a single node's, or Zero's membership),
/admin/maintenance and the /debug surface (server/debug_routes.py).
stdlib `ThreadingHTTPServer`: every request runs on its own thread
against the one Alpha, whose reads run on its device (the card by
default), so concurrent requests share the card; `engine/fused.py`
captures CUDA graphs safely while other request threads serve.

Each POST runs under a disconnect watcher: a client that closes its
socket mid-request cancels the request's context
(`request_cancelled_total{stage="disconnect"}`), so the request stops
at its next checkpoint and releases its admission token, its read
registration and its cost record. Errors map to codes: 409 aborted txn,
429 shed (`Retry-After`), 504 deadline (the stage named), 499 cancel,
401 ACL, 400 anything else. A budget comes from `?timeout=` (Go
duration form) or `X-Deadline-Ms`; an inbound `X-Trace-Id` joins the
caller's trace and every answer echoes its trace id.

Over a clustered Alpha (`cluster.start_cluster_alpha`), /state is Zero's
membership, `/debug/peers` the node's breaker table and `/debug/fleet`
every node's snapshot gathered over the worker transport
(server/fleet.py); `/debug/traces?peer=` pulls a peer's spans. Those
branches import `grpc` when they run, so a single-node server loads no
`grpc`. `/debug/fleet/flight?peer=` pulls a peer's flight-recorder
snapshot over the `DebugFlight` RPC; `/debug/flightrecorder` (GET the
ring and watchdog, POST a one-shot bundle), `/debug/timeseries`,
`/debug/slo`, `/debug/locks` and `/debug/races` serve the flight
recorder, the sampler, the SLO engine and the sanitizers
(`utils/{flightrec,timeseries,slo,locks}.py`).

    srv = make_http_server(alpha, "127.0.0.1", 0)
    serve_background(srv)          # port: srv.server_address[1]
"""

from __future__ import annotations

import contextlib
import json
import math
import select
import socket
import threading
import time
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dgraph_tpu_torch.dql.upsert import is_upsert as _is_upsert
from dgraph_tpu_torch.server.admission import ServerOverloaded
from dgraph_tpu_torch.server.api import Alpha, TxnAborted
from dgraph_tpu_torch.server.debug_routes import DEBUG_ENDPOINTS
from dgraph_tpu_torch.utils import costprofile, flightrec, locks, tracing
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import logging as xlog
from dgraph_tpu_torch.utils.deadline import Cancelled, DeadlineExceeded
from dgraph_tpu_torch.utils.metrics import METRICS

# runtime debug route tables: path → Handler method name. Keyed on the
# same paths as the DEBUG_ENDPOINTS inventory (server/debug_routes.py);
# tests/test_torch_http.py pins table ↔ inventory in both directions.
_DEBUG_GET = {
    "/debug": "_dbg_index",
    "/debug/prometheus_metrics": "_dbg_metrics",
    "/debug/traces": "_dbg_traces",
    "/debug/events": "_dbg_events",
    "/debug/costs": "_dbg_costs",
    "/debug/slow_queries": "_dbg_slow_queries",
    "/debug/profile": "_dbg_profile",
    "/debug/scheduler": "_dbg_scheduler",
    "/debug/admission": "_dbg_admission",
    "/debug/locks": "_dbg_locks",
    "/debug/races": "_dbg_races",
    "/debug/peers": "_dbg_peers",
    "/debug/flightrecorder": "_dbg_flightrec",
    "/debug/fleet": "_dbg_fleet",
    "/debug/fleet/flight": "_dbg_fleet_flight",
    "/debug/memory": "_dbg_memory",
    "/debug/timeseries": "_dbg_timeseries",
    "/debug/slo": "_dbg_slo",
}
_DEBUG_POST = {
    "/debug/profile": "_post_profile",
    "/debug/flightrecorder": "_post_flightrec",
}


def _route_of(path: str, table: dict) -> str | None:
    """Longest-prefix match of a request path against a route table
    ("/debug" itself matches only exactly — it is the index, not a
    catch-all)."""
    p = path.partition("?")[0].rstrip("/") or "/"
    if p == "/debug" and "/debug" in table:
        return "/debug"
    best = None
    for route in table:
        if route != "/debug" and p.startswith(route):
            if best is None or len(route) > len(best):
                best = route
    return best

# structured slow-query ring: every --slow_query_ms overrun keeps its
# trace_id alongside the log line, so GET /debug/slow_queries →
# /debug/traces?trace_id= resolves a slow query's full span tree in
# one hop (the log-line form carried the id; nothing served it)
_SLOW_MAX = 256
_SLOW_LOG: deque = deque(maxlen=_SLOW_MAX)
_SLOW_LOCK = locks.make_lock("http.slowlog")


def slow_queries_snapshot(trace_id: str | None = None) -> list[dict]:
    """The slow-query ring as served by /debug/slow_queries."""
    now = dl.monotonic_s()
    with _SLOW_LOCK:
        entries = [e for e in _SLOW_LOG
                   if trace_id is None or e["trace_id"] == trace_id]
    return [{**{k: v for k, v in e.items() if k != "mono_s"},
             "age_s": round(now - e["mono_s"], 3)}
            for e in entries]

# how often the per-request watcher peeks the client socket for a
# mid-request disconnect (an abandoned request must release its
# admission token early instead of computing into the void)
DISCONNECT_POLL_S = 0.05


def _socket_closed(conn) -> bool:
    """Has the client closed its end? A zero-byte MSG_PEEK read on a
    readable socket means EOF; pending request bytes (pipelining) mean
    it is alive. Never consumes data, never blocks."""
    try:
        r, _w, _x = select.select([conn], [], [], 0)
        if not r:
            return False
        flags = socket.MSG_PEEK | getattr(socket, "MSG_DONTWAIT", 0)
        return conn.recv(1, flags) == b""
    except (BlockingIOError, InterruptedError):
        return False
    except (OSError, ValueError):
        # the socket object itself is dead (closed under the poll: its
        # descriptor reads -1, which select refuses with ValueError)
        return True


def _parse_timeout_ms(val: str) -> float:
    """`?timeout=` value → ms. Accepts the Dgraph/Go duration forms the
    reference takes (`500ms`, `2s`, `1m`) and a bare number (seconds)."""
    v = val.strip().lower()
    try:
        if v.endswith("ms"):
            return float(v[:-2])
        if v.endswith("s") and not v.endswith("ms"):
            return float(v[:-1]) * 1e3
        if v.endswith("m"):
            return float(v[:-1]) * 60e3
        return float(v) * 1e3
    except ValueError:
        raise ValueError(f"bad timeout value {val!r}: want e.g. "
                         f"500ms, 2s, or seconds as a number") from None


def make_http_server(alpha: Alpha, addr: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    start_time = dl.monotonic_s()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet (x.Logger role is utils.logging)
            pass

        def _send(self, code: int, body: dict | str,
                  ctype: str = "application/json"):
            data = (json.dumps(body) if not isinstance(body, str)
                    else body).encode()
            self._send_bytes(code, data, ctype)

        def _send_bytes(self, code: int, data: bytes,
                        ctype: str = "application/json",
                        headers: dict | None = None):
            held = getattr(self, "_held", None)
            if held is not None:     # answered once its span is recorded
                held.append((code, data, ctype, headers))
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _deadline_ms(self):
            """Request budget from `?timeout=` (Go-duration form) or the
            `X-Deadline-Ms` header (None = server default applies)."""
            qs = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query)
            t = (qs.get("timeout") or [None])[0]
            if t:
                return _parse_timeout_ms(t)
            h = self.headers.get("X-Deadline-Ms")
            return float(h) if h else None

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(n)

        @contextlib.contextmanager
        def _disconnect_watch(self):
            """Cancel this request's context when the client hangs up
            mid-flight. The handler thread's ACTIVE context is looked up
            per poll: the context is created later, inside
            Alpha._request, on that thread."""
            stop = threading.Event()
            ident = threading.get_ident()
            conn = self.connection

            def watch():
                while not stop.wait(DISCONNECT_POLL_S):
                    # a socket the server closed after the request ended
                    # is no disconnect; nor may a later thread that took
                    # the same ident be cancelled
                    if _socket_closed(conn) and not stop.is_set():
                        ctx = dl.of_thread(ident)
                        if ctx is not None and not ctx.cancelled:
                            METRICS.inc("request_cancelled_total",
                                        stage="disconnect")
                            ctx.cancel()
                        return

            t = threading.Thread(target=watch, daemon=True)
            t.start()
            try:
                yield
            finally:
                stop.set()

        def do_GET(self):
            if self.path == "/health":
                self._send(200, [{"status": "healthy",
                                  "uptime": int(dl.monotonic_s() - start_time)}])
            elif self.path == "/state":
                if alpha.groups is not None:
                    # cluster mode: real topology from Zero, including
                    # liveness (reference: /state mirrors the membership
                    # stream with health marking). Zero being down must
                    # produce an error RESPONSE, not a crashed handler.
                    import grpc as _grpc
                    try:
                        ms = alpha.groups.zero.membership()
                    except _grpc.RpcError as e:
                        self._send(503, {"errors": [{
                            "message": f"zero unreachable: {e.code()}"}]})
                        return
                    dead = {int(d) for d in ms.dead}

                    def group_doc(grp):
                        # any-coordinator design: no raft leader; the
                        # flag marks the lowest LIVE member for shape
                        # parity (none when the whole group is dark)
                        live = [int(m) for m in grp.nodes
                                if int(m) not in dead]
                        lead = min(live) if live else None
                        return {
                            "members": {str(n): {
                                "id": str(n), "addr": a,
                                "leader": int(n) == lead,
                                "alive": int(n) not in dead}
                                for n, a in grp.nodes.items()},
                            "tablets": {p: {"predicate": p}
                                        for p in grp.tablets}}

                    st = {"counter": int(ms.counter),
                          "groups": {str(g): group_doc(grp)
                                     for g, grp in ms.groups.items()},
                          "dead": sorted(dead),
                          "maxUID": alpha.mvcc.uid_high(),
                          "maxTxnTs": alpha.oracle.max_assigned}
                else:
                    st = {"counter": alpha.oracle.max_assigned,
                          "groups": {"1": {"members": {"1": {
                              "id": "1", "addr": f"{addr}:{port}",
                              "leader": True, "alive": True}},
                              "tablets": {p: {"predicate": p}
                                          for p in
                                          alpha.mvcc.schema.predicates}}},
                          "dead": [],
                          "maxUID": alpha.oracle.max_uid,
                          "maxTxnTs": alpha.oracle.max_assigned}
                self._send(200, st)
            elif (route := _route_of(self.path, _DEBUG_GET)) is not None:
                getattr(self, _DEBUG_GET[route])()
            elif self.path.startswith("/admin/maintenance"):
                # scheduler status: running/queued jobs, pause state,
                # policy knobs (reference: /admin health of background
                # ops; the metric counterparts live in
                # /debug/prometheus_metrics)
                if alpha.maintenance is None:
                    self._send(400, {"errors": [{
                        "message": "maintenance scheduler not attached"}]})
                else:
                    self._send(200, alpha.maintenance.status())
            else:
                self._send(404, {"errors": [{"message": "not found"}]})

        # -- /debug surface (dispatch via _DEBUG_GET; every route has
        # -- an inventory row in server/debug_routes.py — lint-pinned)
        def _qs(self):
            return urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query)

        def _dbg_index(self):
            # the operator's map: every debug endpoint with its
            # one-liner, straight from the lint-pinned inventory
            self._send(200, {"endpoints": [
                {"path": p, "doc": d}
                for p, d in sorted(DEBUG_ENDPOINTS.items())]})

        def _dbg_metrics(self):
            # identity gauges (build_info / process_uptime_s) refresh
            # at render time so every scrape carries a live uptime
            from dgraph_tpu_torch.server import fleet
            fleet.refresh_identity_metrics()
            self._send(200, METRICS.render(), "text/plain")

        def _dbg_traces(self):
            # span JSON: ?trace_id=… resolves one request's spans
            # (the id echoed in that response's extensions); bare
            # GET returns the recent ring buffer
            spans = self._debug_spans()
            self._send(200, {"spans": [s.to_dict() for s in spans]})

        def _dbg_events(self):
            # the same spans as Chrome trace-event JSON — load the
            # body directly in Perfetto / chrome://tracing
            spans = self._debug_spans()
            self._send(200, tracing.to_chrome(spans))

        def _dbg_costs(self):
            # shape-keyed query cost profiles: per-shape percentile
            # digests + feature means + the top-N most expensive
            # shapes (utils/costprofile.py — the cost-model dataset)
            qs = self._qs()
            n = int((qs.get("n") or [10])[0])
            doc = costprofile.summary(top_n=n)
            # whole-block program cache (engine/fused.py): hits,
            # misses, captures + the shapes pinned to the staged route
            from dgraph_tpu_torch.engine import fused
            doc["fused_programs"] = fused.status()
            if (qs.get("recent") or ["false"])[0] == "true":
                doc["recent"] = costprofile.recent(min(n, 100))
            self._send(200, doc)

        def _dbg_slow_queries(self):
            # the slow-query ring; ?trace_id= filters to one
            # request, whose span tree is one hop away at
            # /debug/traces?trace_id=
            tid = (self._qs().get("trace_id") or [None])[0]
            self._send(200,
                       {"slow_queries": slow_queries_snapshot(tid)})

        def _dbg_profile(self):
            # capture status; POST starts/stops (single-flight)
            self._send(200, tracing.profile_status())

        def _dbg_scheduler(self):
            # cost-prior scheduling state (utils/costprior.py):
            # live priors with hit/fallback counts, predicted-vs-
            # actual error digests, lane-EMA fallbacks, the feature
            # least-squares fit, and the admission lanes' predicted
            # inflight/queued work
            from dgraph_tpu_torch.utils import costprior
            n = int((self._qs().get("n") or [10])[0])
            doc = {"enabled": costprior.enabled(),
                   **costprior.status(top_n=n)}
            if alpha.admission is not None:
                doc["admission"] = alpha.admission.status()
            # mesh-route view: the shard-keyed cost sums the mesh
            # expansions record (engine/execute.py), how the scheduler
            # sees work land across the mesh's shards
            shard_cost = costprofile.shard_costs()
            if shard_cost:
                doc["mesh"] = {"shard_cost_us": shard_cost}
            # fused-vs-staged route selection (engine/fused.py):
            # per-route counts + the program cache
            from dgraph_tpu_torch.engine import fused
            doc["fused"] = {
                "routes": {r: METRICS.get("fused_route_total", route=r)
                           for r in ("fused", "staged", "fallback")},
                **fused.status()}
            self._send(200, doc)

        def _dbg_admission(self):
            # admission-control status: per-lane inflight/queued/
            # shed counts + limits (the numbers the overload
            # acceptance test cross-checks against metrics)
            if alpha.admission is None:
                self._send(200, {"enabled": False})
            else:
                self._send(200, {"enabled": True,
                                 **alpha.admission.status()})

        def _dbg_peers(self):
            # per-peer resilience state: breaker state, EMA
            # latency, consecutive failures, last error — the
            # operator's answer to "which replica is dying on us"
            # (cluster/resilience.py PeerTable.snapshot)
            if alpha.groups is None:
                self._send(200, {"enabled": False})
            else:
                res = getattr(alpha.groups, "resilience", None)
                doc = {"enabled": res is not None,
                       "peers": res.snapshot() if res else {}}
                zh = getattr(alpha.groups.zero, "health", None)
                if zh is not None:
                    doc["zero"] = zh.snapshot()
                self._send(200, doc)

        def _dbg_fleet(self):
            # cluster-wide snapshot (server/fleet.py): fan out over
            # every known node through the pooled, breaker-aware
            # clients; merge cost digests exactly and instance-label
            # the metrics. Partial on peer failure — never a 500.
            from dgraph_tpu_torch.server import fleet
            qs = self._qs()
            budget = float((qs.get("budget_ms")
                            or [fleet.FLEET_BUDGET_MS])[0])
            self._send_bytes(200, json.dumps(
                fleet.fleet_snapshot(alpha, budget_ms=budget),
                default=str).encode())

        def _dbg_fleet_flight(self):
            # a node's flight-recorder snapshot (in-flight ops with
            # stacks + ring + watchdog); ?peer=host:port pulls a
            # cluster peer's over the DebugFlight worker RPC — the
            # operator's manual form of the watchdog's peer pull
            qs = self._qs()
            peer = (qs.get("peer") or [None])[0]
            n = int((qs.get("n") or [256])[0])
            if peer:
                from dgraph_tpu_torch.server.task import Client
                c = Client(peer)
                try:
                    doc = c.debug_flight(n)
                finally:
                    c.close()
            else:
                doc = flightrec.flight_snapshot(n)
            self._send_bytes(200, json.dumps(doc,
                                             default=str).encode())

        def _dbg_memory(self):
            # memory-governor snapshot (utils/memgov.py): budgets +
            # watermarks, per-cache resident bytes/registrants/
            # evictions, allocation-failure counters, degraded shapes
            from dgraph_tpu_torch.utils import memgov
            self._send(200, memgov.GOVERNOR.status())

        def _dbg_timeseries(self):
            # retained metrics history (utils/timeseries.py): the
            # sampler ring's windowed points — ?name= filters series
            # by prefix, ?window= bounds the lookback seconds,
            # ?rate=false serves raw counter deltas instead of rates
            from dgraph_tpu_torch.utils import timeseries
            qs = self._qs()
            name = (qs.get("name") or [None])[0]
            window = (qs.get("window") or [None])[0]
            rate = (qs.get("rate") or ["true"])[0] != "false"
            self._send_bytes(200, json.dumps(timeseries.status(
                name=name,
                window_s=float(window) if window else None,
                rate=rate), default=str).encode())

        def _dbg_slo(self):
            # SLO engine state (utils/slo.py): every inventoried
            # objective with its target and both windows' burn rates,
            # breach counts, and the sustained-burn conviction feed
            from dgraph_tpu_torch.utils import slo
            eng = slo.ENGINE
            if eng is None:
                self._send(200, {"armed": False})
            else:
                self._send_bytes(200, json.dumps(
                    {"armed": True, **eng.status()},
                    default=str).encode())

        def _dbg_locks(self):
            # lock-order sanitizer state: acquisition-graph edges,
            # detected cycles (each with both stacks), long holds
            # (utils/locks.py; enabled under
            # DGRAPH_TPU_LOCK_SANITIZER=1, else a stub)
            self._send(200, locks.GRAPH.snapshot())

        def _dbg_races(self):
            # Eraser lockset race sanitizer state: tracked classes +
            # every report, each with both access stacks
            # (utils/locks.py; enabled under
            # DGRAPH_TPU_RACE_SANITIZER=1, else a stub)
            self._send(200, locks.RACES.snapshot())

        def _dbg_flightrec(self):
            # flight-recorder state (utils/flightrec.py): ring tail,
            # watchdog config + conviction counts, recent dumps
            n = int((self._qs().get("n") or [100])[0])
            self._send_bytes(200, json.dumps(flightrec.state(n),
                                             default=str).encode())

        def _post_flightrec(self, acl_user):
            # one-shot diagnostic bundle (admin bar): {"action":
            # "dump"} builds the full bundle — stacks, flight ring,
            # every debug surface, metrics, config — writes it under
            # the armed diag dir (when one is configured) and returns
            # it inline
            if alpha.acl is not None:
                alpha.acl.check_alter(acl_user)
            body = self._body().decode()
            req = json.loads(body) if body.strip() else {}
            action = req.get("action", "dump")
            if action != "dump":
                self._send(400, {"errors": [{
                    "message": f"unknown action {action!r} "
                               f"(want dump)"}]})
                return
            out = flightrec.dump(trigger="http", alpha=alpha,
                                 reason=req.get("reason"))
            self._send_bytes(200, json.dumps(
                {"data": {"path": out["path"],
                          "bundle": out["bundle"]}},
                default=str).encode())

        def _post_profile(self, acl_user):
            # on-demand torch.profiler device capture (admin bar):
            # {"action": "start"|"stop", "dir"?: path}. start while
            # one is running → 409 (single-flight, tracing.py); the
            # Chrome trace lands as <dir>/trace-*.json
            if alpha.acl is not None:
                alpha.acl.check_alter(acl_user)
            body = self._body().decode()
            req = json.loads(body) if body.strip() else {}
            action = req.get("action", "start")
            try:
                if action == "start":
                    d = tracing.profile_start(req.get("dir")
                                              or None)
                    self._send(200, {"data": {"profiling": True,
                                              "dir": d}})
                elif action == "stop":
                    d = tracing.profile_stop()
                    self._send(200, {"data": {"profiling": False,
                                              "dir": d}})
                else:
                    self._send(400, {"errors": [{
                        "message": f"unknown action {action!r} "
                                   f"(want start|stop)"}]})
            except RuntimeError as e:
                # single-flight conflict / no capture running
                self._send(409, {"errors": [{"message": str(e)}]})

        def _debug_spans(self):
            qs = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query)
            tid = (qs.get("trace_id") or [None])[0]
            n = int((qs.get("n") or [256])[0])
            peer = (qs.get("peer") or [None])[0]
            if peer:
                # proxy to the peer's registry over the worker
                # transport (DebugTraces RPC): peer-leg spans become
                # reachable from THIS node's debug surface
                from dgraph_tpu_torch.server.task import Client
                c = Client(peer)
                try:
                    dicts = c.debug_traces(trace_id=tid or "", n=n)
                finally:
                    c.close()
                return [tracing.Span(**d) for d in dicts]
            if tid:
                return tracing.trace_spans(tid)
            return tracing.recent(n)

        def _slow_query_check(self, us: int, trace_id: str,
                              q: str) -> None:
            """Slow-query log (reference: the query log at --v=3 /
            slow-query tooling): queries past --slow_query_ms log with
            their trace id so the spans can be pulled from
            /debug/traces after the fact; the structured entry also
            lands in the /debug/slow_queries ring, filterable by
            ?trace_id= (one-hop correlation to the span tree)."""
            thresh_ms = getattr(alpha, "slow_query_ms", 0) or 0
            if thresh_ms <= 0 or us < thresh_ms * 1000:
                return
            METRICS.inc("slow_queries_total")
            xlog.get("http").warning(
                "slow query: %.1f ms (threshold %s ms) trace_id=%s "
                "query=%.200s", us / 1000.0, thresh_ms, trace_id,
                " ".join(q.split()))
            with _SLOW_LOCK:
                _SLOW_LOG.append({
                    "trace_id": trace_id, "us": int(us),
                    "threshold_ms": thresh_ms,
                    "query": " ".join(q.split())[:200],
                    "mono_s": dl.monotonic_s()})

        def _explain_doc(self, trace_id: str) -> dict:
            """The request's finished cost record (utils/costprofile —
            the same record /debug/costs?recent=true serves), joined
            by trace id: no new accounting, just the existing
            breakdown echoed where the caller can see it."""
            for rec in reversed(costprofile.recent(64)):
                if rec.get("trace_id") == trace_id:
                    return rec
            return {"trace_id": trace_id,
                    "note": "no finished cost record for this request "
                            "(cost profiling disabled?)"}

        def _acl_user(self):
            """Resolve the access token when ACL is on (reference: the
            accessJwt header gate on every endpoint)."""
            if alpha.acl is None:
                return None
            token = (self.headers.get("X-Dgraph-AccessToken")
                     or self.headers.get("X-Dgraph-AccessJWT"))
            return alpha.acl.verify(token)

        def _admin(self, acl_user):
            """Admin triggers for the maintenance scheduler (reference:
            /admin backup + export GraphQL mutations): POST
            /admin/backup {"dest": …, "full"?: bool}, /admin/export
            {"out": …, "format"?: "rdf"|"json"}, /admin/checkpoint,
            /admin/pause, /admin/resume. Jobs queue on the background
            scheduler; `?wait=true` blocks for the outcome (admin
            endpoints share the Alter ACL bar).

            Every admin request opens (or, via an inbound X-Trace-Id,
            joins) a trace; jobs it queues capture the trace id and
            the scheduler re-establishes it around `maintenance.job`
            (store/maintenance.py) — an operator-initiated backup is
            traceable end to end even though it runs later on the
            scheduler thread. The answer goes out once the trace's
            `http.admin` span is recorded, so a client that reads the
            trace on its answer finds the whole of it."""
            held = self._held = []
            try:
                with tracing.trace(
                        "http.admin",
                        trace_id=self.headers.get("X-Trace-Id") or None,
                        path=self.path.partition("?")[0]) as tid:
                    self._admin_dispatch(acl_user, tid)
            finally:
                self._held = None
            for answer in held:
                self._send_bytes(*answer)

        def _admin_dispatch(self, acl_user, tid):
            if alpha.acl is not None:
                alpha.acl.check_alter(acl_user)
            if self.path.startswith("/admin/backup/verify"):
                # offline chain integrity walk (no scheduler needed —
                # read-only): manifests, per-file digests, delta record
                # counts, contiguity; errors name exact files
                from dgraph_tpu_torch.server.backup import verify_chain
                req = json.loads(self._body().decode() or "{}")
                self._send(200, {"data": verify_chain(req["dest"])})
                return
            if alpha.maintenance is None:
                self._send(400, {"errors": [{
                    "message": "maintenance scheduler not attached"}]})
                return
            sched = alpha.maintenance
            body = self._body().decode()
            req = json.loads(body) if body.strip() else {}
            wait = "wait=true" in (self.path.partition("?")[2] or "")
            if self.path.startswith("/admin/backup"):
                job = sched.request_backup(req["dest"],
                                           force_full=req.get("full",
                                                              False))
            elif self.path.startswith("/admin/export"):
                job = sched.request_export(req["out"],
                                           format=req.get("format",
                                                          "rdf"))
            elif self.path.startswith("/admin/checkpoint"):
                job = sched.request_checkpoint()
            elif self.path.startswith("/admin/pause"):
                sched.pause()
                self._send(200, {"data": {"paused": True}})
                return
            elif self.path.startswith("/admin/resume"):
                sched.resume()
                self._send(200, {"data": {"paused": False}})
                return
            else:
                self._send(404, {"errors": [{"message": "not found"}]})
                return
            if wait:
                result = job.wait(timeout=600.0)
                self._send(200, {"data": {"job": job.name,
                                          "outcome": "ok",
                                          "result": result,
                                          "trace_id": tid}})
            else:
                self._send(200, {"data": {"job": job.name,
                                          "queued": True,
                                          "trace_id": tid}})

        def do_POST(self):
            t0 = time.perf_counter()
            try:
                with self._disconnect_watch():
                    self._dispatch_post(t0)
            except TxnAborted as e:
                self._send(409, {"errors": [{"message": str(e),
                                             "code": "Aborted"}]})
            except ServerOverloaded as e:
                # RETRYABLE shed: 429 + a Retry-After hint scaled by
                # the lane's measured service time — clients and load
                # balancers back off instead of hammering. The header
                # is RFC 9110's delay-seconds, a whole number (the
                # reference sends "0.100", which integer parsers
                # reject): the hint rounded up, at least 1; the body
                # keeps it in ms precision
                METRICS.inc("http_overload_responses_total")
                self._send_bytes(
                    429,
                    json.dumps({"errors": [{
                        "message": str(e),
                        "code": "ServerOverloaded",
                        "retry_after_s": round(e.retry_after_s, 3)}]}
                    ).encode(),
                    headers={"Retry-After":
                             str(max(1, math.ceil(e.retry_after_s)))})
            except DeadlineExceeded as e:
                # RETRYABLE: the request's own budget expired — 504
                # (the server gave up inside the client's deadline
                # contract, not a client error)
                self._send(504, {"errors": [{"message": str(e),
                                             "code": "DeadlineExceeded",
                                             "stage": e.stage}]})
            except Cancelled as e:
                # 499 (client-closed-request convention): the client
                # cancelled; nothing to retry unless it wants to. On a
                # DISCONNECT cancel the socket is gone — the write
                # fails quietly; the point was releasing the request's
                # admission token and compute early.
                with contextlib.suppress(OSError):
                    self._send(499, {"errors": [{"message": str(e),
                                                 "code": "Cancelled"}]})
            except PermissionError as e:
                self._send(401, {"errors": [{"message": str(e),
                                             "code": "Unauthorized"}]})
            except Exception as e:  # surface parse/exec errors as the
                # reference does: 200-with-errors JSON is api-breaking,
                # use 400 + errors list (`query_errors_total{lane=}` is
                # counted once, in the api._request lifecycle, so gRPC
                # and embedded callers burn the same SLO budget)
                self._send(400, {"errors": [{"message": str(e)}]})

        def _dispatch_post(self, t0):
            """POST endpoint dispatch; raised errors map to
            HTTP codes in do_POST's handler chain."""
            if self.path.startswith("/login"):
                req = json.loads(self._body().decode())
                if alpha.acl is None:
                    self._send(400, {"errors": [
                        {"message": "ACL is not enabled"}]})
                    return
                token = alpha.acl.login(req.get("userid", ""),
                                        req.get("password", ""))
                self._send(200, {"data": {"accessJWT": token}})
                return
            acl_user = self._acl_user()
            post_route = _route_of(self.path, _DEBUG_POST)
            if post_route is not None:
                getattr(self, _DEBUG_POST[post_route])(acl_user)
                return
            deadline_ms = self._deadline_ms()
            # inbound X-Trace-Id joins the caller's trace (the HTTP
            # twin of the gRPC metadata propagation); the id echoes
            # back as an X-Trace-Id response header either way
            inbound_tid = self.headers.get("X-Trace-Id") or None
            if self.path.startswith("/query/batch"):
                req = json.loads(self._body().decode())
                with tracing.trace("http.query_batch",
                                   trace_id=inbound_tid,
                                   queries=len(req["queries"])) as tid:
                    outs = alpha.query_batch(req["queries"],
                                             acl_user=acl_user,
                                             deadline_ms=deadline_ms)
                us = int((time.perf_counter() - t0) * 1e6)
                METRICS.observe("query_latency_us", us,
                                endpoint="query_batch")
                self._slow_query_check(us, tid,
                                       f"<batch of "
                                       f"{len(req['queries'])}>")
                self._send_bytes(
                    200,
                    json.dumps({"data": outs,
                                "extensions": {"trace_id": tid}}
                               ).encode(),
                    headers={"X-Trace-Id": tid})
            elif self.path.startswith("/query"):
                body = self._body().decode()
                if "application/json" in (
                        self.headers.get("Content-Type") or ""):
                    req = json.loads(body)
                    q, variables = req["query"], req.get("variables")
                else:
                    q, variables = body, None
                # ?explain=true (or an X-Explain request header):
                # echo the request's cost-Recorder breakdown — route
                # per hop, kernel launches, launch-gap µs, cache hit
                # bits, admission wait — in the response extensions.
                # One-hop introspection over EXISTING accounting.
                explain = ("explain=true" in self.path.partition("?")[2]
                           or (self.headers.get("X-Explain") or ""
                               ).lower() in ("1", "true"))
                with tracing.trace("http.query",
                                   trace_id=inbound_tid) as tid:
                    raw = alpha.query_raw(q, variables,
                                          acl_user=acl_user,
                                          deadline_ms=deadline_ms)
                us = int((time.perf_counter() - t0) * 1e6)
                METRICS.observe("query_latency_us", us,
                                endpoint="query")
                self._slow_query_check(us, tid, q)
                # splice the emitter's bytes into the envelope — the
                # response body is never re-parsed server-side
                env = (b'{"data":' + raw +
                       b',"extensions":{"server_latency":'
                       b'{"total_us":%d},"trace_id":"%s"'
                       % (us, tid.encode()))
                headers = {"X-Trace-Id": tid}
                if explain:
                    env += (b',"explain":'
                            + json.dumps(self._explain_doc(tid),
                                         default=str).encode())
                    headers["X-Explain"] = "true"
                self._send_bytes(200, env + b'}}', headers=headers)
            elif self.path.startswith("/mutate"):
                ctype = self.headers.get("Content-Type") or ""
                body = self._body().decode()
                qs = self.path.partition("?")[2]
                start_ts = None
                for part in qs.split("&"):
                    if part.startswith("startTs="):
                        start_ts = int(part.split("=", 1)[1])
                commit_now = "commitNow=true" in qs or \
                    (self.headers.get("X-Dgraph-CommitNow") == "true")
                if "application/json" in ctype:
                    req = json.loads(body)
                    if req.get("query"):
                        # upsert: set/delete may be JSON mutation
                        # lists (upsert_json) or RDF strings (the
                        # block form, via Alpha.upsert)
                        cn = commit_now or req.get("commitNow", False)
                        if any(isinstance(req.get(k), str)
                               for k in ("set", "delete")):
                            parts = [
                                "%s { %s }" % (k if k != "delete"
                                               else "delete", req[k])
                                for k in ("set", "delete")
                                if isinstance(req.get(k), str)]
                            src = ("upsert { query %s mutation %s "
                                   "{ %s } }"
                                   % (req["query"],
                                      req.get("cond", ""),
                                      "\n".join(parts)))
                            res = alpha.upsert(
                                src, commit_now=cn,
                                start_ts=start_ts,
                                acl_user=acl_user,
                                deadline_ms=deadline_ms)
                        else:
                            res = alpha.upsert_json(
                                req["query"], req.get("cond", ""),
                                set_json=req.get("set"),
                                del_json=req.get("delete"),
                                commit_now=cn, start_ts=start_ts,
                                acl_user=acl_user,
                                deadline_ms=deadline_ms)
                    else:
                        res = alpha.mutate(
                            set_json=req.get("set"),
                            del_json=req.get("delete"),
                            commit_now=(commit_now or
                                        req.get("commitNow", False)),
                            start_ts=start_ts, acl_user=acl_user,
                            deadline_ms=deadline_ms)
                elif _is_upsert(body):
                    res = alpha.upsert(body, commit_now=commit_now,
                                       start_ts=start_ts,
                                       acl_user=acl_user,
                                       deadline_ms=deadline_ms)
                else:
                    res = alpha.mutate(set_nquads=body,
                                       commit_now=commit_now,
                                       start_ts=start_ts,
                                       acl_user=acl_user,
                                       deadline_ms=deadline_ms)
                self._send(200, {"data": res})
            elif self.path.startswith("/commit"):
                qs = self.path.partition("?")[2]
                start_ts = abort = None
                for part in qs.split("&"):
                    if part.startswith("startTs="):
                        start_ts = int(part.split("=", 1)[1])
                    if part.startswith("abort="):
                        abort = part.split("=", 1)[1] == "true"
                if start_ts is None:
                    self._send(400, {"errors": [
                        {"message": "startTs required"}]})
                    return
                cts = alpha.commit_or_abort(start_ts,
                                            abort=bool(abort),
                                            deadline_ms=deadline_ms)
                self._send(200, {"data": {
                    "code": "Success", "commit_ts": cts}})
            elif self.path.startswith("/admin/"):
                self._admin(acl_user)
            elif self.path.startswith("/alter"):
                if alpha.acl is not None:
                    alpha.acl.check_alter(acl_user)
                body = self._body().decode()
                if body.strip().startswith("{"):
                    op = json.loads(body)
                    if op.get("drop_all"):
                        alpha.drop_all()
                    elif op.get("drop_attr"):
                        alpha.drop_attr(op["drop_attr"])
                    else:
                        alpha.alter(op.get("schema", ""))
                else:
                    alpha.alter(body)
                self._send(200, {"data": {"code": "Success"}})
            else:
                self._send(404, {"errors": [{"message": "not found"}]})

    srv = _Server((addr, port), Handler)
    port = srv.server_address[1]
    return srv


class _Server(ThreadingHTTPServer):
    """`ThreadingHTTPServer` with a listen backlog for bursts: the
    standard library's 5 overflows when a few dozen clients connect at
    once, and the kernel then resets some of their connections before
    the server can shed them with a 429."""

    request_queue_size = 128


def serve_background(srv: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t
