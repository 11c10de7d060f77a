"""Flight recorder: always-on black box + predicted-cost watchdog.

Port of `dgraph_tpu/utils/flightrec.py`. The unattended half of the
telemetry stack, for the stall nobody was watching:

* **Flight ring** — a bounded event ring that taps the span and
  cost-record streams (`tracing.add_sink`, `costprofile.add_sink`) and
  takes `emit()` events: admission sheds, breaker transitions,
  maintenance jobs, storage corruption and heal, the memory governor's
  `memory.oom` / `memory.degrade`, SLO breaches. A full ring drops its
  OLDEST event, counted in `flight_ring_dropped_total{kind=}`.

* **Watchdog daemon** — one thread that walks the in-flight registry
  (`Alpha._request` registers every request through `track_request`,
  a benchmark harness registers a stage through `track` with a
  budget) and convicts without per-workload thresholds: the cost priors
  (`utils/costprior.py`) predict what a request should cost, so a
  request `stall_factor`× past its prediction (shape prior, then lane
  EMA, then `stall_floor_ms`) is the anomaly. A request with a deadline
  is judged against it instead: cooperative cancellation fires first,
  so only a request past its budget by `grace_s` is convicted
  ("wedged"). It also watches an admission lane's queue head, a
  maintenance job that stops advancing, the governor's sticky degrades,
  a sustained SLO burn and a wedged telemetry pusher. Convictions count
  `watchdog_stalls_total{kind=}`. The watchdog never waits on the card:
  it reads Python stacks from `sys._current_frames()`, and its only
  device call, the optional capture below, takes `DEVICE_WIDE` with a
  timeout.

* **Diagnostic bundle** — on conviction (and on SIGUSR2, or `POST
  /debug/flightrecorder {"action": "dump"}`) one JSON bundle lands in
  `diag_dir` via `store/vault.atomic_write`: every thread's stack, the
  ring, the in-flight registry (each op with its stack, trace spans and
  predicted cost), a snapshot of every debug surface (traces, events,
  costs, scheduler, locks, races, memory, slow queries, admission,
  peers, time series), the metrics exposition and the config. Dumps
  count `flight_dumps_total{trigger=}` and are rate-limited (watchdog
  triggers honor `min_dump_interval_s`, operator triggers bypass). With
  `capture_device=True` a watchdog dump also takes a short
  `torch.profiler` capture of the card through `tracing.profile_start`
  / `profile_stop` (single-flight); the bundle's `device_profile` names
  the trace file and the kernels it saw, or the conflict when the card
  is busy (another capture, or `DEVICE_WIDE` held past the timeout).

The ring, registry and watchdog are process-wide, as in the reference:
a process serving several Alphas arms the recorder with one of them,
and a bundle's surfaces are that Alpha's.

Disarmed (the default), the module starts no thread, subscribes no
sink, and every hook (`emit`, `track`, `rpc_leg`) is one global load
and a None check.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
import traceback
from collections import deque

from dgraph_tpu_torch.utils import costprior, costprofile
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import locks
from dgraph_tpu_torch.utils import logging as xlog
from dgraph_tpu_torch.utils import tracing
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["FlightRing", "Watchdog", "arm", "disarm", "armed", "emit",
           "track", "track_request", "rpc_leg", "rpc_in_flight",
           "flight_snapshot", "dump", "request_dump", "state",
           "dumps", "RING_MAX", "STALL_FACTOR", "STALL_FLOOR_MS"]

RING_MAX = 2048            # events retained in the flight ring
RING_SPAN_MIN_US = 1000    # child spans below this skip the ring
POLL_S = 0.25              # watchdog scan cadence
STALL_FACTOR = 10.0        # conviction at factor × predicted cost
STALL_FLOOR_MS = 500.0     # prediction fallback + conviction floor
GRACE_S = 1.0              # slack past a deadline before "wedged"
MIN_DUMP_INTERVAL_S = 30.0  # watchdog dump rate limit
MAINT_STALL_S = 120.0      # maintenance job with no tablet progress
DUMPS_MAX = 16             # recent-dump records retained
PEER_FLIGHT_BUDGET_MS = 2000.0  # DebugFlight pull budget per conviction
CAPTURE_WAIT_S = 1.0       # longest wait for DEVICE_WIDE in a capture


def _now_ms() -> int:
    # graftlint: allow(wall-clock): bundle/ring timestamps CROSS the
    # process boundary — the dump file is read offline, long after this
    # process (and its monotonic epoch) is gone
    return int(time.time() * 1e3)


class FlightRing:
    """Bounded event ring (the black box). One lock, integer-bounded
    memory; a full ring drops its OLDEST event and counts the drop by
    the evicted event's kind."""

    def __init__(self, cap: int = RING_MAX):
        self._lock = locks.make_lock("flightrec.ring")
        self._buf: deque = deque()
        self.cap = int(cap)
        self.added = 0
        locks.guarded(self, "flightrec.ring")

    def add(self, kind: str, fields: dict | None = None) -> None:
        ev = {"kind": kind, "t_ms": _now_ms()}
        if fields:
            ev.update(fields)
        dropped = None
        with self._lock:
            if len(self._buf) >= self.cap:
                dropped = self._buf.popleft()["kind"]
            self._buf.append(ev)
            self.added += 1
        if dropped is not None:
            METRICS.inc("flight_ring_dropped_total", kind=dropped)

    def recent(self, n: int | None = None) -> list[dict]:
        with self._lock:
            buf = list(self._buf)
        return buf if n is None else buf[-n:]

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._buf), "cap": self.cap,
                    "added": self.added}


class _Tracked:
    """One registered in-flight operation (a request or a benchmark
    stage). Plain record: written by its own thread at registration,
    `convicted` flipped only by the single watchdog thread."""

    __slots__ = ("op_id", "name", "lane", "predicted_us", "query",
                 "trace_id", "ident", "started", "budget_deadline",
                 "ctx", "convicted")

    def to_dict(self, now: float) -> dict:
        d = {"name": self.name, "lane": self.lane,
             "elapsed_us": int((now - self.started) * 1e6),
             "predicted_us": self.predicted_us,
             "trace_id": self.trace_id, "query": self.query,
             "convicted": self.convicted}
        deadline = self._deadline()
        if deadline is not None:
            d["budget_remaining_s"] = round(deadline - now, 3)
        return d

    def _deadline(self) -> float | None:
        if self.ctx is not None and self.ctx.deadline is not None:
            return self.ctx.deadline
        return self.budget_deadline


# in-flight registry: module-level like tracing's span ring — the
# watchdog and the bundle code walk it from their own threads
_OPS_LOCK = locks.make_lock("flightrec.ops")
_OPS: dict[int, _Tracked] = {}
_IDS = itertools.count(1)

# outstanding outbound RPC per thread: ident → (peer, rpc, started).
# Single writer per thread (the calling thread itself) + lock-free
# watchdog reads — the same CPython-atomic plain-dict discipline
# utils/deadline.py's _ACTIVE uses. This is how a conviction names the
# wedged PEER: the convicted request's thread is sitting inside a leg.
_RPC_INFLIGHT: dict[int, tuple] = {}

# recent dump records (path/trigger/reason), bundle-independent so the
# HTTP surface can list them without re-reading disk
_DUMPS_LOCK = locks.make_lock("flightrec.dumps")
_DUMPS: list[dict] = []

_STATE = None          # _State | None — armed configuration
_PREV_SIG = None       # previous SIGUSR2 handler (restored on disarm)


class Watchdog:
    """The anomaly scanner (see module doc). One daemon thread; all
    mutable bookkeeping under one lock so the HTTP state() view and
    the scan thread never race."""

    def __init__(self, *, poll_s: float, stall_factor: float,
                 stall_floor_ms: float, grace_s: float,
                 min_dump_interval_s: float, maintenance_stall_s: float,
                 alpha=None, pusher=None):
        self.poll_s = max(float(poll_s), 0.01)
        self.stall_factor = float(stall_factor)
        self.stall_floor_ms = float(stall_floor_ms)
        self.grace_s = float(grace_s)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.maintenance_stall_s = float(maintenance_stall_s)
        self.alpha = alpha
        self.pusher = pusher
        self._lock = locks.make_lock("flightrec.watchdog")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._dump_now: list[str] = []     # operator-requested triggers
        self._kind_last: dict[str, float] = {}  # per-kind conviction gate
        self._last_dump_mono = float("-inf")
        self._maint_seen = (None, -1, 0.0)  # (job, progress, since)
        # governor sticky-degrade count at last scan; None until the
        # first scan baselines it (a watchdog armed AFTER an old
        # degrade must not convict history)
        self._oom_seen = None
        self.convictions = 0
        self.suppressed = 0
        locks.guarded(self, "flightrec.watchdog")

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dgraph-flight-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def request_dump(self, trigger: str) -> None:
        """Queue an operator dump (SIGUSR2 path): the NEXT scan writes
        it from the watchdog thread — a signal handler must never walk
        locks the interrupted frame may hold."""
        with self._lock:
            self._dump_now.append(trigger)

    # -- the scan -------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the watchdog must outlive bugs
                xlog.get("flightrec").exception("watchdog tick failed")

    def _tick(self) -> None:
        now = dl.monotonic_s()
        with self._lock:
            pending, self._dump_now = self._dump_now, []
        for trig in pending:
            self._dump(trig, reason={"kind": "requested"}, now=now,
                       force=True)
        convicted: list[tuple[str, dict]] = []
        with _OPS_LOCK:
            ops = list(_OPS.values())
        for op in ops:
            verdict = self._judge(op, now)
            if verdict is not None:
                convicted.append(verdict)
        convicted.extend(self._scan_admission(now))
        convicted.extend(self._scan_maintenance(now))
        convicted.extend(self._scan_pusher())
        convicted.extend(self._scan_memory(now))
        convicted.extend(self._scan_slo(now))
        for kind, detail in convicted:
            METRICS.inc("watchdog_stalls_total", kind=kind)
            emit("watchdog.stall", stall=kind, **{
                k: v for k, v in detail.items()
                if isinstance(v, (str, int, float, bool))})
            self._dump("watchdog", reason={"kind": kind, **detail},
                       now=now)

    def _judge(self, op: _Tracked, now: float):
        """One in-flight op: deadline-carrying ops are judged only
        against their (fault-extended) budget — cooperative
        cancellation fires first, so past-deadline-plus-grace means
        WEDGED, not merely slow. Unbounded ops are judged against
        `stall_factor`× their cost prediction."""
        if op.convicted:
            return None
        deadline = op._deadline()
        if deadline is not None:
            if now > deadline + self.grace_s:
                op.convicted = True
                return ("wedged", {"op": _op_evidence(op, now),
                                   **_peer_leg(op)})
            return None
        base_us = op.predicted_us
        if base_us is None and op.lane:
            base_us = costprior.lane_ema_us(op.lane)
        if base_us is None or base_us <= 0:
            base_us = self.stall_floor_ms * 1e3
        threshold_us = max(self.stall_factor * base_us,
                           self.stall_floor_ms * 1e3)
        if (now - op.started) * 1e6 > threshold_us:
            op.convicted = True
            return ("request", {"threshold_us": int(threshold_us),
                                "op": _op_evidence(op, now),
                                **_peer_leg(op)})
        return None

    def _scan_admission(self, now: float):
        adm = getattr(self.alpha, "admission", None) \
            if self.alpha is not None else None
        if adm is None:
            return []
        out = []
        for lane, hw in adm.head_waits().items():
            slack_s = max(self.stall_factor * hw["service_ema_s"],
                          self.stall_floor_ms / 1e3)
            if hw["wait_s"] > slack_s and self._kind_due("queue_head",
                                                         now):
                out.append(("queue_head", {
                    "lane": lane, "head_wait_s": round(hw["wait_s"], 3),
                    "slack_s": round(slack_s, 3)}))
        return out

    def _scan_maintenance(self, now: float):
        maint = getattr(self.alpha, "maintenance", None) \
            if self.alpha is not None else None
        if maint is None:
            return []
        st = maint.status()
        running, prog = st.get("running"), st.get("progress", 0)
        with self._lock:
            job0, prog0, since = self._maint_seen
            if running is None or running != job0 or prog != prog0:
                self._maint_seen = (running, prog, now)
                return []
            stalled_s = now - since
        if stalled_s > self.maintenance_stall_s \
                and self._kind_due("maintenance", now):
            return [("maintenance", {"job": running, "progress": prog,
                                     "stalled_s": round(stalled_s, 1)})]
        return []

    def _scan_pusher(self):
        p = self.pusher
        if p is None:
            return []
        st = p.status()
        buffered = st.get("buffered_spans", 0) + st.get("buffered_costs",
                                                        0)
        if not buffered:
            return []
        wedge_s = max(3.0 * st.get("interval_s", 5.0),
                      st.get("backoff_s", 0.0) + self.grace_s) \
            + self.grace_s
        dead = not st.get("alive", True)
        stale = st.get("last_cycle_age_s", 0.0) > wedge_s
        if (dead or stale) and self._kind_due("pusher",
                                              dl.monotonic_s()):
            return [("pusher", {"buffered": buffered, "dead": dead,
                                "last_cycle_age_s":
                                    st.get("last_cycle_age_s")})]
        return []

    def _scan_memory(self, now: float):
        """Repeat-OOM conviction (kind=oom): the memory governor
        absorbing a single allocation failure with one evict-retry is
        the design working — no conviction. A shape going
        STICKY-degraded means the allocation failed AGAIN after the
        evict pass (the repeat the budget could not absorb): that is a
        capsized budget the black box should explain — convict once per
        dump interval with the governor's counters as evidence."""
        from dgraph_tpu_torch.utils import memgov
        st = memgov.GOVERNOR.oom_stats()
        with self._lock:
            deg0 = self._oom_seen
            self._oom_seen = st["degraded"]
        if deg0 is None:
            return []  # first scan baselines; history never convicts
        if st["degraded"] > deg0 and self._kind_due("oom", now):
            return [("oom", {"events": st["events"],
                             "retries": st["retries"],
                             "degraded": st["degraded"]})]
        return []

    def _scan_slo(self, now: float):
        """Sustained fast-burn conviction (kind=slo): the SLO engine's
        edge-triggered breach already paged (`slo_breaches_total` + a
        `slo.breach` flight event with an exemplar trace id); a FAST
        burn that stays breached across the engine's sustain threshold
        is an ongoing regression the black box should explain — convict
        once per dump interval, so the bundle's "timeseries" surface
        records the approach, not just the crash."""
        from dgraph_tpu_torch.utils import slo as _slo
        eng = _slo.ENGINE
        if eng is None:
            return []
        out = []
        for c in eng.convictable():
            if self._kind_due("slo", now):
                out.append(("slo", c))
        return out

    def _kind_due(self, kind: str, now: float) -> bool:
        """Condition-shaped convictions (queue head, maintenance,
        pusher) persist across scans — gate re-conviction of the same
        kind on the dump interval so one wedge is one report stream,
        not one per poll."""
        with self._lock:
            if now - self._kind_last.get(kind, float("-inf")) \
                    < self.min_dump_interval_s:
                return False
            self._kind_last[kind] = now
            return True

    # -- dumping --------------------------------------------------------------
    def _dump(self, trigger: str, reason: dict, now: float,
              force: bool = False) -> None:
        with self._lock:
            self.convictions += not force
            if not force and now - self._last_dump_mono \
                    < self.min_dump_interval_s:
                self.suppressed += 1
                return
            self._last_dump_mono = now
        try:
            dump(trigger=trigger, reason=reason, alpha=self.alpha)
        except Exception:  # noqa: BLE001 — a failed dump must not kill the scan
            xlog.get("flightrec").exception("flight dump failed")

    def state(self) -> dict:
        with self._lock:
            return {"armed": True, "poll_s": self.poll_s,
                    "stall_factor": self.stall_factor,
                    "stall_floor_ms": self.stall_floor_ms,
                    "grace_s": self.grace_s,
                    "min_dump_interval_s": self.min_dump_interval_s,
                    "maintenance_stall_s": self.maintenance_stall_s,
                    "convictions": self.convictions,
                    "suppressed": self.suppressed}


class _State:
    """Armed configuration: the ring, the watchdog, sink closures, and
    the dump context. Write-once at arm() — the hooks only read."""

    def __init__(self, ring: FlightRing, diag_dir: str | None, alpha,
                 pusher, config: dict | None, capture_device: bool,
                 on_dump):
        self.ring = ring
        self.diag_dir = diag_dir
        self.alpha = alpha
        self.pusher = pusher
        self.config = dict(config or {})
        self.capture_device = bool(capture_device)
        self.on_dump = on_dump
        self.watchdog: Watchdog | None = None

    # sink closures (bound methods keep add/remove_sink idempotent)
    def span_sink(self, s) -> None:
        # black-box selectivity: request-root spans and anything ≥1 ms.
        # Micro-spans (per-level expands, lock holds) would displace
        # the interesting history within milliseconds AND bill the hot
        # path (<5% guard); their full fidelity already lives in
        # tracing's own ring, snapshotted into every bundle.
        if s.parent_id and s.dur_us < RING_SPAN_MIN_US:
            return
        self.ring.add("span", {"name": s.name, "trace_id": s.trace_id,
                               "dur_us": s.dur_us, "tid": s.tid})

    def cost_sink(self, rec: dict) -> None:
        self.ring.add("cost", {"shape": rec.get("shape"),
                               "lane": rec.get("lane"),
                               "outcome": rec.get("outcome"),
                               "total_us": rec.get("total_us"),
                               "trace_id": rec.get("trace_id")})


# -- arming -------------------------------------------------------------------

def arm(*, diag_dir: str | None = None, stall_factor: float = STALL_FACTOR,
        stall_floor_ms: float = STALL_FLOOR_MS, poll_s: float = POLL_S,
        grace_s: float = GRACE_S,
        min_dump_interval_s: float = MIN_DUMP_INTERVAL_S,
        maintenance_stall_s: float = MAINT_STALL_S,
        ring_max: int = RING_MAX, alpha=None, pusher=None,
        config: dict | None = None, signals: bool = False,
        capture_device: bool = False, on_dump=None,
        watchdog: bool = True):
    """Arm the flight recorder: subscribe the ring to the span/cost
    streams and (default) start the watchdog daemon. Re-arming
    disarms the previous configuration first. `signals=True` installs
    the SIGUSR2 dump trigger (main thread only; silently skipped
    elsewhere). `on_dump(record, bundle)` observes every dump (a harness
    uses it to surface a wedged stage's bundle path)."""
    global _STATE
    if _STATE is not None:
        disarm()
    with _DUMPS_LOCK:  # a fresh arming starts a fresh dump ledger
        del _DUMPS[:]
    st = _State(FlightRing(ring_max), diag_dir, alpha, pusher, config,
                capture_device, on_dump)
    tracing.add_sink(st.span_sink)
    costprofile.add_sink(st.cost_sink)
    _STATE = st
    if watchdog:
        st.watchdog = Watchdog(
            poll_s=poll_s, stall_factor=stall_factor,
            stall_floor_ms=stall_floor_ms, grace_s=grace_s,
            min_dump_interval_s=min_dump_interval_s,
            maintenance_stall_s=maintenance_stall_s, alpha=alpha,
            pusher=pusher).start()
    if signals:
        _install_sigusr2()
    return st


def disarm() -> None:
    """Tear down: unsubscribe sinks, stop the watchdog thread, restore
    the SIGUSR2 handler, forget the registry and dump records."""
    global _STATE
    st = _STATE
    if st is None:
        return
    tracing.remove_sink(st.span_sink)
    costprofile.remove_sink(st.cost_sink)
    if st.watchdog is not None:
        st.watchdog.stop()
    _restore_sigusr2()
    _STATE = None
    with _OPS_LOCK:
        _OPS.clear()
    _RPC_INFLIGHT.clear()
    with _DUMPS_LOCK:
        del _DUMPS[:]


def armed() -> bool:
    return _STATE is not None


def _install_sigusr2() -> None:
    global _PREV_SIG
    import signal

    def handler(_signum, _frame):
        # only mark: the dump runs on the watchdog thread (or a fresh
        # one) — the interrupted frame may hold any lock
        request_dump("sigusr2")

    try:
        _PREV_SIG = signal.signal(signal.SIGUSR2, handler)
    except ValueError:  # not the main thread: no signal trigger
        _PREV_SIG = None


def _restore_sigusr2() -> None:
    global _PREV_SIG
    if _PREV_SIG is None:
        return
    import signal
    with contextlib.suppress(ValueError):
        signal.signal(signal.SIGUSR2, _PREV_SIG)
    _PREV_SIG = None


# -- hook surface (cheap when disarmed) ---------------------------------------

def emit(kind: str, **fields) -> None:
    """Record one subsystem event into the flight ring (admission
    sheds, breaker transitions, maintenance outcomes, corruption/heal
    events). One global load + None check when disarmed."""
    st = _STATE
    if st is not None:
        st.ring.add(kind, fields)


@contextlib.contextmanager
def track(name: str, budget_s: float | None = None,
          predicted_us: float | None = None, lane: str = "",
          ctx=None, query: str | None = None):
    """Register an operation in the in-flight registry for the
    watchdog to walk. `ctx` (a RequestContext) contributes its live
    deadline; `budget_s` sets an explicit one (a benchmark's stages). Yields
    the tracked record (None when disarmed)."""
    if _STATE is None:
        yield None
        return
    op = _Tracked()
    op.op_id = next(_IDS)
    op.name = name
    op.lane = lane
    op.predicted_us = (float(predicted_us)
                       if predicted_us is not None else None)
    op.query = " ".join(query.split())[:200] if query else None
    op.trace_id = tracing.current_trace_id()
    op.ident = threading.get_ident()
    op.started = dl.monotonic_s()
    op.budget_deadline = (op.started + budget_s
                          if budget_s is not None else None)
    op.ctx = ctx
    op.convicted = False
    with _OPS_LOCK:
        _OPS[op.op_id] = op
    try:
        yield op
    finally:
        with _OPS_LOCK:
            _OPS.pop(op.op_id, None)


def track_request(ctx, lane: str, predicted_us: float | None = None,
                  query: str | None = None):
    """`Alpha._request`'s registration shell: the request rides its
    RequestContext (live deadline) and its costprior prediction."""
    return track(f"request.{lane}", ctx=ctx, lane=lane,
                 predicted_us=predicted_us, query=query)


@contextlib.contextmanager
def rpc_leg(peer: str, rpc: str):
    """Mark an outbound RPC as in flight on this thread
    (server/task.py Client._attempt wraps every wire attempt): when
    the watchdog convicts a request whose thread is sitting inside a
    leg, the conviction names the wedged PEER — not just the wedged
    request — and the bundle pulls that peer's flight snapshot over
    the DebugFlight RPC. One global load + None check when disarmed."""
    if _STATE is None:
        yield
        return
    ident = threading.get_ident()
    prev = _RPC_INFLIGHT.get(ident)
    _RPC_INFLIGHT[ident] = (peer, rpc, dl.monotonic_s())
    try:
        yield
    finally:
        if prev is None:
            _RPC_INFLIGHT.pop(ident, None)
        else:
            _RPC_INFLIGHT[ident] = prev


def rpc_in_flight(ident: int) -> tuple | None:
    """(peer, rpc, started_mono) of the RPC `ident`'s thread is inside
    right now (None = no outstanding leg)."""
    return _RPC_INFLIGHT.get(ident)


def _peer_leg(op: _Tracked) -> dict:
    leg = _RPC_INFLIGHT.get(op.ident)
    if leg is None:
        return {}
    return {"peer": leg[0], "peer_rpc": leg[1]}


def request_dump(trigger: str) -> None:
    """Queue a dump out-of-band (the SIGUSR2 handler's path). Runs on
    the watchdog thread when armed with one, else on a one-shot
    thread — never on the requesting frame."""
    st = _STATE
    if st is None:
        return
    if st.watchdog is not None:
        st.watchdog.request_dump(trigger)
    else:
        threading.Thread(target=dump, kwargs={"trigger": trigger},
                         daemon=True).start()


# -- the diagnostic bundle ----------------------------------------------------

def _op_evidence(op: _Tracked, now: float) -> dict:
    """One tracked op's full evidence — identity, live stack, and the
    completed spans of its trace. The watchdog pins this at CONVICTION
    time (a short-lived stall may finish before the bundle is built;
    the evidence must survive it); the bundle reuses it for
    everything still in flight."""
    d = op.to_dict(now)
    frame = sys._current_frames().get(op.ident)
    if frame is not None:
        d["stack"] = "".join(traceback.format_stack(frame))
    if op.trace_id:
        d["spans"] = [s.to_dict()
                      for s in tracing.trace_spans(op.trace_id)]
    return d


def dump(trigger: str = "manual", reason: dict | None = None,
         alpha=None, write: bool = True) -> dict:
    """Build (and write, when a diag dir is known) one self-contained
    diagnostic bundle. Returns {"path": str|None, "bundle": dict}.
    Works disarmed too (the HTTP surface must produce a bundle
    from any live server) — the ring and
    watchdog sections are then empty/absent."""
    st = _STATE
    if alpha is None and st is not None:
        alpha = st.alpha
    bundle = _build_bundle(trigger, reason, alpha, st)
    path = None
    if write and st is not None and st.diag_dir:
        try:
            path = _write_bundle(st.diag_dir, trigger, bundle)
        except OSError:
            xlog.get("flightrec").exception(
                "could not write flight bundle under %s", st.diag_dir)
    METRICS.inc("flight_dumps_total", trigger=trigger)
    record = {"path": path, "trigger": trigger, "t_ms": bundle["t_ms"],
              "reason": reason}
    with _DUMPS_LOCK:
        _DUMPS.append(record)
        del _DUMPS[:-DUMPS_MAX]
    if st is not None and st.on_dump is not None:
        try:
            st.on_dump(record, bundle)
        except Exception:  # noqa: BLE001 — an observer must never fail a dump
            pass
    return {"path": path, "bundle": bundle}


def _build_bundle(trigger: str, reason: dict | None, alpha,
                  st: "_State | None") -> dict:
    now = dl.monotonic_s()
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {f"{names.get(ident, 'thread')}-{ident}":
              "".join(traceback.format_stack(frame))
              for ident, frame in frames.items()}
    with _OPS_LOCK:
        ops = list(_OPS.values())
    inflight = []
    for op in ops:
        d = _op_evidence(op, now)
        d["thread"] = names.get(op.ident, "thread")
        inflight.append(d)
    bundle = {
        "version": 1,
        "trigger": trigger,
        "reason": reason,
        "t_ms": _now_ms(),
        "stacks": stacks,
        "inflight": inflight,
        "ring": st.ring.recent() if st is not None else [],
        "watchdog": (st.watchdog.state()
                     if st is not None and st.watchdog is not None
                     else {"armed": False}),
        "dumps": dumps(),
        "surfaces": _surfaces(alpha),
        "metrics": METRICS.render(),
        "config": st.config if st is not None else {},
    }
    if reason is not None and reason.get("peer"):
        # peer-correlated diagnostics: the conviction named the peer
        # its stuck RPC leg is wedged on — pull THAT node's in-flight
        # snapshot + flight ring so the bundle answers "wedged on
        # whom" offline (budget-bounded; a dark peer degrades to an
        # error field, never a failed dump)
        bundle["peer_flight"] = _pull_peer_flight(
            alpha, reason["peer"], reason.get("peer_rpc"))
    if st is not None and st.capture_device \
            and trigger.startswith("watchdog"):
        bundle["device_profile"] = _device_capture()
    return bundle


def _pull_peer_flight(alpha, addr: str, rpc: str | None) -> dict:
    """The implicated peer's flight snapshot over the DebugFlight
    worker RPC — through the shared pooled client (breaker-aware) when
    the alpha is clustered, an ad-hoc client otherwise."""
    out: dict = {"addr": addr}
    if rpc:
        out["rpc"] = rpc
    groups = getattr(alpha, "groups", None) if alpha is not None else None
    try:
        with dl.activate(dl.RequestContext(PEER_FLIGHT_BUDGET_MS)):
            if groups is not None:
                out["flight"] = groups.pool(addr).debug_flight()
            else:
                from dgraph_tpu_torch.server.task import Client
                c = Client(addr)
                try:
                    out["flight"] = c.debug_flight()
                finally:
                    c.close()
        METRICS.inc("peer_flight_pulls_total", outcome="ok")
    except Exception as e:  # noqa: BLE001 — a dark peer must not fail the dump
        out["error"] = f"{type(e).__name__}: {e}"[:300]
        METRICS.inc("peer_flight_pulls_total", outcome="error")
    return out


def flight_snapshot(n: int = 256) -> dict:
    """The DebugFlight RPC / `/debug/fleet/flight` document: every
    in-flight op WITH its evidence (stack + trace spans), the threads'
    outstanding RPC legs, the flight ring tail, watchdog state, and
    recent dumps — state()'s peer-correlated twin. Works disarmed
    (ring/watchdog sections then empty), like dump()."""
    now = dl.monotonic_s()
    with _OPS_LOCK:
        ops = list(_OPS.values())
    doc: dict = {
        "armed": _STATE is not None,
        "inflight": [_op_evidence(op, now) for op in ops],
        "rpcs_in_flight": [
            {"thread": ident, "peer": leg[0], "rpc": leg[1],
             "age_s": round(now - leg[2], 3)}
            for ident, leg in list(_RPC_INFLIGHT.items())],
        "dumps": dumps(),
    }
    st = _STATE
    doc["ring"] = st.ring.recent(n) if st is not None else []
    doc["watchdog"] = (st.watchdog.state()
                       if st is not None and st.watchdog is not None
                       else {"armed": False})
    return doc


def _surfaces(alpha) -> dict:
    """Snapshot every debug surface the HTTP layer serves — the bundle
    must answer offline anything `/debug/*` would have answered live."""
    spans = tracing.recent(256)
    out = {
        "traces": [s.to_dict() for s in spans],
        "events": tracing.to_chrome(spans),
        "costs": costprofile.summary(top_n=10),
        "scheduler": costprior.status(top_n=10),
        "locks": locks.GRAPH.snapshot(),
        "races": locks.RACES.snapshot(),
    }
    # memory-governor state: an OOM/degrade conviction's
    # bundle must carry the budgets, per-cache residency, and the
    # sticky-degraded shapes that explain it
    from dgraph_tpu_torch.utils import memgov
    out["memory"] = memgov.GOVERNOR.status()
    try:
        from dgraph_tpu_torch.server.http import slow_queries_snapshot
        out["slow_queries"] = slow_queries_snapshot()
    except Exception:  # noqa: BLE001 — surface optional outside a server
        out["slow_queries"] = []
    adm = getattr(alpha, "admission", None) if alpha is not None else None
    out["admission"] = ({"enabled": True, **adm.status()}
                        if adm is not None else {"enabled": False})
    groups = getattr(alpha, "groups", None) if alpha is not None else None
    res = getattr(groups, "resilience", None) if groups is not None \
        else None
    out["peers"] = ({"enabled": True, "peers": res.snapshot()}
                    if res is not None else {"enabled": False})
    # retained history: the last minutes LEADING UP TO this
    # dump — per-series rates and latency percentiles plus SLO states,
    # so a conviction bundle shows the approach, not just the crash
    try:
        from dgraph_tpu_torch.utils import timeseries
        out["timeseries"] = timeseries.recent_window(300.0)
    except Exception:  # noqa: BLE001 — surface optional when disarmed
        out["timeseries"] = None
    return out


def _device_capture(capture_s: float = 0.25) -> dict:
    """A short torch.profiler capture of the card for a watchdog dump,
    through `tracing.profile_start` / `profile_stop` (single-flight).
    The watchdog must never wait on the card: both calls take
    `DEVICE_WIDE` with a `CAPTURE_WAIT_S` timeout, and a capture already
    running, or the lock held past the timeout by another thread's
    CUDA-graph capture, is reported as the conflict. A stop that times
    out is finished by a helper thread."""
    try:
        d = tracing.profile_start(wide_timeout_s=CAPTURE_WAIT_S)
    except (RuntimeError, ValueError) as e:
        return {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — profiling must never fail a dump
        return {"error": f"{type(e).__name__}: {e}"}
    before = set(os.listdir(d)) if os.path.isdir(d) else set()
    time.sleep(capture_s)
    try:
        tracing.profile_stop(wide_timeout_s=CAPTURE_WAIT_S)
    except tracing.CardBusy as e:
        threading.Thread(target=tracing.profile_stop, daemon=True,
                         name="dgraph-flight-capture-stop").start()
        return {"dir": d, "error": str(e)}
    except Exception as e:  # noqa: BLE001 — profiling must never fail a dump
        return {"dir": d, "error": f"{type(e).__name__}: {e}"}
    out: dict = {"dir": d}
    new = sorted(set(os.listdir(d)) - before)
    if new:
        out["trace"] = os.path.join(d, new[-1])
        out["kernels"] = _trace_kernels(out["trace"])
    return out


def _trace_kernels(path: str) -> list[str]:
    """The distinct device kernel names in a Chrome trace."""
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, ValueError):
        return []
    return sorted({e.get("name", "") for e in events
                   if isinstance(e, dict) and e.get("cat") == "kernel"})


_DUMP_SEQ = itertools.count(1)


def _write_bundle(diag_dir: str, trigger: str, bundle: dict) -> str:
    from dgraph_tpu_torch.store import vault
    os.makedirs(diag_dir, exist_ok=True)
    safe = "".join(c if c.isalnum() else "-" for c in trigger)
    path = os.path.join(
        diag_dir,
        f"flight-{safe}-{bundle['t_ms']}-{next(_DUMP_SEQ)}.json")
    vault.atomic_write(path,
                       json.dumps(bundle, default=str).encode())
    return path


# -- surfacing ---------------------------------------------------------------

def state(n: int = 100) -> dict:
    """The `GET /debug/flightrecorder` document: ring tail + watchdog
    state + recent dumps + in-flight count."""
    st = _STATE
    doc: dict = {"armed": st is not None, "dumps": dumps()}
    with _OPS_LOCK:
        doc["inflight"] = len(_OPS)
    if st is not None:
        doc["diag_dir"] = st.diag_dir
        doc["ring"] = st.ring.recent(n)
        doc["ring_stats"] = st.ring.stats()
        doc["watchdog"] = (st.watchdog.state()
                           if st.watchdog is not None
                           else {"armed": False})
    return doc


def dumps() -> list[dict]:
    """Recent dump records (newest last)."""
    with _DUMPS_LOCK:
        return [dict(d) for d in _DUMPS]
