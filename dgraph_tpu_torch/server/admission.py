"""Admission control: bounded concurrency, FIFO queueing, load shedding.

Port of `dgraph_tpu/server/admission.py`. The reference bounds work at
the `worker.Task` gRPC boundary with context deadlines and lets gRPC's
stream limits shed the rest; a serving stack at north-star traffic
needs the explicit form: a token-based concurrency
limit per LANE (reads and mutations don't starve each other), a bounded
FIFO wait queue in front of each, and shedding: when the queue is full
the request is REFUSED with a retryable `ServerOverloaded` carrying a
retry-after hint, rather than queued into a latency collapse.

The retry-after hint: with cost priors on (utils/costprior.py) every
request arrives with a predicted cost (`Alpha._request` reads a
prediction of 0 µs or less as none and sends the lane's observed-cost
EMA instead), and the hint is the predicted work ahead of the would-be
waiter (inflight + queued predicted µs, divided across the lane's
tokens). Without a prediction each lane falls back to an EMA of observed
service time, decayed back to its seed after an idle period, so a quiet
lane's stale EMA can't shape the first hints of the next burst.

Predictions change two decisions, and leave the classic behavior
untouched when they are absent (`cost_us=None`):

  * **Cheapest-predicted-first handoff**: release hands the token to the
    cheapest PREDICTED waiter instead of the oldest. A starvation guard
    restores FIFO for any waiter older than `starvation_s`.
  * **Cost-aware displacement**: when the queue is full, an arriving
    request cheaper than the most expensive queued waiter DISPLACES it
    (the expensive waiter is shed, `shed_total{reason="displaced"}`).
    Every cost-informed shed records its predicted cost
    (`shed_predicted_cost_us`).

Queued waiters respect the request's deadline: a request whose budget
expires while waiting is shed (`shed_total{reason="deadline"}`). A
memory governor still above its high watermark after an eviction pass
(`memgov.GOVERNOR.admission_pressure`) sheds arrivals before the queue
fills (`reason="memory_pressure"`). With the time-series sampler armed,
its Holt forecast of the lane's arrivals times the predicted cost sheds
an arrival while the hint is still short (`reason="forecast"`,
`forecast_sheds_total{lane=}`). Every shed is an `admission.shed` event
in the flight recorder's ring, and `head_waits()` is its watchdog's
queue-head stall signal.

The maintenance scheduler consults `saturated()` at tablet boundaries
and yields the machine while real traffic is queued
(store/maintenance.py `_pace`).

Over a mesh that spans processes only the lead's controller decides
(server/api.py `_request`); a follower's counts the lead's verdicts
(`follow`, `follow_shed`): it takes a token for every request the lead
admitted, whatever it already holds, and sheds exactly the requests the
lead shed, with the lead's reason and retry-after hint, so its status
and metrics stay those of the requests it served.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from dgraph_tpu_torch.utils import (costprofile, flightrec, locks, memgov,
                                    timeseries, tracing)
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["AdmissionController", "ServerOverloaded", "LANES"]

LANES = ("read", "mutate")

# service-time EMA smoothing + the floor the retry-after hint never
# drops below (a hint of 0 would make clients hammer-retry)
_EMA_ALPHA = 0.2
_MIN_RETRY_S = 0.01
# EMA cold-start: the seed before any observation, and how long a lane
# may sit idle before its EMA is considered stale and reset to the seed
# (a quiet lane's last burst must not shape the next one's hints)
_EMA_SEED_S = 0.05
_EMA_IDLE_RESET_S = 30.0
# SJF starvation guard: a waiter queued longer than this is served
# FIFO regardless of predicted cost
_STARVATION_S = 5.0


class ServerOverloaded(Exception):
    """RETRYABLE: the lane's wait queue is full — the server sheds
    rather than queue into latency collapse. `retry_after_s` is the
    server's estimate of when a slot frees up (HTTP surfaces it as a
    `Retry-After` header + 429)."""

    def __init__(self, msg: str, retry_after_s: float = _MIN_RETRY_S,
                 lane: str = "", reason: str = ""):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.lane = lane
        self.reason = reason


class _Waiter:
    __slots__ = ("event", "granted", "displaced", "cost_us", "seq",
                 "enq_mono")

    def __init__(self, cost_us: float | None, seq: int):
        self.event = threading.Event()
        self.granted = False
        self.displaced = False          # shed by a cheaper arrival
        self.cost_us = cost_us          # predicted cost (None = unknown)
        self.seq = seq                  # arrival order (FIFO tie-break)
        self.enq_mono = time.monotonic()


class _Lane:
    """One admission lane: `max_inflight` tokens + a FIFO queue bounded
    at `queue_depth` (cost-aware handoff/displacement when predictions
    ride along — see module doc)."""

    def __init__(self, name: str, max_inflight: int, queue_depth: int):
        self.name = name
        self.max_inflight = max(1, int(max_inflight))
        self.queue_depth = max(0, int(queue_depth))
        self.lock = locks.make_lock(f"admission.{name}")
        self.inflight = 0
        self.waiters: deque[_Waiter] = deque()
        self.admitted_total = 0
        self.shed_total = 0
        self.service_ema_s = _EMA_SEED_S  # seed; real spans take over
        self.idle_reset_s = _EMA_IDLE_RESET_S
        self.starvation_s = _STARVATION_S
        self._seq = 0
        self._last_activity = time.monotonic()
        # predicted µs currently admitted (cost-aware retry hints)
        self.inflight_cost_us = 0.0
        locks.guarded(self, "admission.*")

    # -- gauges ---------------------------------------------------------------
    def _publish(self) -> None:
        """Caller holds the lock."""
        METRICS.set_gauge("admission_inflight", float(self.inflight),
                          lane=self.name)
        METRICS.set_gauge("admission_queued", float(len(self.waiters)),
                          lane=self.name)

    def _maybe_decay_ema(self, now: float) -> None:
        """Caller holds the lock. An idle lane's EMA is stale evidence:
        after `idle_reset_s` without activity it resets to the seed, so
        the first retry hints of the next burst aren't shaped by
        whatever the LAST burst happened to look like (the cold-start
        fix — regression-tested in tests/test_admission.py)."""
        if now - self._last_activity > self.idle_reset_s:
            self.service_ema_s = _EMA_SEED_S

    def _queued_cost_us(self) -> float:
        """Caller holds the lock: predicted µs waiting in the queue
        (unknown costs count as one EMA service time)."""
        ema_us = self.service_ema_s * 1e6
        return sum(w.cost_us if w.cost_us is not None else ema_us
                   for w in self.waiters)

    def _retry_after_s(self, queued: int,
                       cost_us: float | None = None) -> float:
        """Predicted work ahead of a would-be waiter, divided across
        the lane's tokens. With cost predictions the hint is the
        predicted µs actually in front (inflight + queued + the arrival
        itself); without, the classic slots-ahead × service-time EMA."""
        if cost_us is not None:
            ahead_us = (self.inflight_cost_us + self._queued_cost_us()
                        + cost_us)
            return max(_MIN_RETRY_S, ahead_us / self.max_inflight / 1e6)
        ahead = (queued + self.inflight) / self.max_inflight
        return max(_MIN_RETRY_S, ahead * self.service_ema_s)

    def _overloaded(self, hint: float, reason: str,
                    cost_us: float | None) -> ServerOverloaded:
        """Caller holds the lock: count one shed and build the error."""
        self.shed_total += 1
        METRICS.inc("shed_total", lane=self.name, reason=reason)
        if cost_us is not None:
            METRICS.observe("shed_predicted_cost_us", cost_us,
                            lane=self.name)
        flightrec.emit("admission.shed", lane=self.name, reason=reason,
                       cost_us=cost_us)
        return ServerOverloaded(
            f"{self.name} lane overloaded: {self.inflight} "
            f"inflight, {len(self.waiters)} queued (limits "
            f"{self.max_inflight}/{self.queue_depth}); retry "
            f"after {hint:.3f}s", retry_after_s=hint,
            lane=self.name, reason=reason)

    def _try_displace(self, cost_us: float) -> bool:
        """Caller holds the lock, queue full: shed the most expensive
        PREDICTED waiter if it is strictly costlier than the arrival —
        sheds land on the work least likely to finish inside anyone's
        deadline. Among equal costs the newest waiter goes (least
        sunk wait). Returns True when a slot was freed."""
        victim = None
        for w in self.waiters:
            if w.cost_us is None or w.cost_us <= cost_us:
                continue
            if victim is None or (w.cost_us, w.seq) > (victim.cost_us,
                                                       victim.seq):
                victim = w
        if victim is None:
            return False
        self.waiters.remove(victim)
        self.shed_total += 1
        METRICS.inc("shed_total", lane=self.name, reason="displaced")
        METRICS.observe("shed_predicted_cost_us", victim.cost_us,
                        lane=self.name)
        flightrec.emit("admission.shed", lane=self.name,
                       reason="displaced", cost_us=victim.cost_us)
        victim.displaced = True
        victim.event.set()
        return True

    # -- token protocol -------------------------------------------------------
    def acquire(self, ctx=None, cost_us: float | None = None) -> None:
        """Take a token, queueing behind earlier waiters (FIFO without
        predictions; cheapest-predicted-first with). Raises
        `ServerOverloaded` when the queue is full (and no costlier
        waiter could be displaced), or the context's
        `DeadlineExceeded`/`Cancelled` when the budget dies while
        queued."""
        with self.lock:
            now = time.monotonic()
            self._maybe_decay_ema(now)
            self._last_activity = now
            # every arrival counts (admitted or shed): the per-lane
            # rate the time-series sampler feeds the load forecast
            METRICS.inc("admission_requests_total", lane=self.name)
            if self.inflight < self.max_inflight and not self.waiters:
                self.inflight += 1
                self.admitted_total += 1
                if cost_us is not None:
                    self.inflight_cost_us += cost_us
                self._publish()
                return
            # sustained memory pressure sheds BEFORE queue-full: when a
            # cache kind is still above its high watermark after a
            # synchronous evict pass, every queued admission only adds
            # cache footprint the budget cannot hold; shed the arrival
            # with a retry hint instead of letting the queue turn memory
            # pressure into allocation failures. Unarmed processes pay
            # one attribute read here.
            pressured = memgov.GOVERNOR.admission_pressure()
            if pressured is not None:
                hint = self._retry_after_s(len(self.waiters), cost_us)
                raise self._overloaded(hint, "memory_pressure", cost_us)
            # predicted-load shedding: the Holt trend over sampled
            # arrival rates × this lane's predicted cost says demand
            # outruns the tokens before the forecast horizon — shed NOW,
            # while the retry hint is still short, instead of after the
            # queue fills. Disarmed: one module-global load + None check.
            if timeseries.forecast_probe(self.name, cost_us,
                                         self.max_inflight):
                METRICS.inc("forecast_sheds_total", lane=self.name)
                hint = self._retry_after_s(len(self.waiters), cost_us)
                raise self._overloaded(hint, "forecast", cost_us)
            if len(self.waiters) >= self.queue_depth:
                if cost_us is None or not self._try_displace(cost_us):
                    hint = self._retry_after_s(len(self.waiters),
                                               cost_us)
                    raise self._overloaded(hint, "queue_full", cost_us)
            self._seq += 1
            w = _Waiter(cost_us, self._seq)
            self.waiters.append(w)
            self._publish()
        t0 = time.perf_counter()
        with tracing.span("admission.wait", lane=self.name):
            while True:
                timeout = None
                if ctx is not None:
                    rem = ctx.remaining_s()
                    if rem is not None:
                        timeout = max(rem, 0.0)
                if w.event.wait(timeout):
                    if w.displaced:
                        # a cheaper arrival took this slot: shed (the
                        # displacer already counted + removed us)
                        with self.lock:
                            hint = self._retry_after_s(
                                len(self.waiters), w.cost_us)
                            self._publish()
                        raise ServerOverloaded(
                            f"{self.name} lane wait displaced by a "
                            f"cheaper request; retry after "
                            f"{hint:.3f}s", retry_after_s=hint,
                            lane=self.name, reason="displaced")
                    break
                # budget died while queued: withdraw — unless release
                # granted the token (or a displacement shed us) in the
                # same instant (checked under the lock), in which case
                # that outcome stands and the next checkpoint raises
                with self.lock:
                    if w.granted:
                        break
                    if not w.displaced:
                        # graftlint: allow(split-critical-section): the deadline-withdraw path — w.granted/w.displaced are re-validated under THIS acquisition before the waiter removes itself; a grant that raced the timeout wins (the break above)
                        self.waiters.remove(w)
                        self.shed_total += 1
                        self._publish()
                        METRICS.inc("shed_total", lane=self.name,
                                    reason="deadline")
                        flightrec.emit("admission.shed",
                                       lane=self.name,
                                       reason="deadline",
                                       cost_us=w.cost_us)
                if ctx is not None:
                    ctx.check("admission")
                raise ServerOverloaded(  # cancel-less fallback
                    f"{self.name} lane wait abandoned", lane=self.name,
                    reason="deadline")
        wait_us = (time.perf_counter() - t0) * 1e6
        METRICS.observe("admission_wait_us", wait_us, lane=self.name)
        costprofile.add("admission_wait_us", int(wait_us))

    def take(self, cost_us: float | None = None) -> None:
        """Take a token the lead granted: counted as an admission
        whatever the lane holds (inflight may pass max_inflight until
        the releases return it); nothing queues and nothing sheds."""
        with self.lock:
            now = time.monotonic()
            self._maybe_decay_ema(now)
            self._last_activity = now
            METRICS.inc("admission_requests_total", lane=self.name)
            self.inflight += 1
            self.admitted_total += 1
            if cost_us is not None:
                self.inflight_cost_us += cost_us
            self._publish()

    def count_shed(self, reason: str, cost_us: float | None = None) -> None:
        """Count a shed the lead decided, under its reason."""
        with self.lock:
            self._last_activity = time.monotonic()
            METRICS.inc("admission_requests_total", lane=self.name)
            if reason == "forecast":
                METRICS.inc("forecast_sheds_total", lane=self.name)
            self.shed_total += 1
            METRICS.inc("shed_total", lane=self.name, reason=reason)
            if cost_us is not None:
                METRICS.observe("shed_predicted_cost_us", cost_us,
                                lane=self.name)
            flightrec.emit("admission.shed", lane=self.name, reason=reason,
                           cost_us=cost_us)

    def _pick_waiter(self) -> _Waiter:
        """Caller holds the lock, waiters non-empty. Without cost
        predictions: FIFO (oldest). With: cheapest-predicted-first,
        arrival order breaking ties — unless the oldest waiter has
        starved past `starvation_s`, which restores its FIFO turn."""
        if all(w.cost_us is None for w in self.waiters):
            return self.waiters.popleft()
        oldest = min(self.waiters, key=lambda w: w.seq)
        if time.monotonic() - oldest.enq_mono > self.starvation_s:
            w = oldest
        else:
            w = min(self.waiters,
                    key=lambda w: (w.cost_us if w.cost_us is not None
                                   else -1.0, w.seq))
        self.waiters.remove(w)
        return w

    def release(self, service_s: float | None = None,
                cost_us: float | None = None) -> None:
        """Return a token; a waiter inherits it (see _pick_waiter)."""
        with self.lock:
            now = time.monotonic()
            self._last_activity = now
            if service_s is not None:
                self.service_ema_s += _EMA_ALPHA * (service_s
                                                    - self.service_ema_s)
            if cost_us is not None:
                self.inflight_cost_us = max(
                    0.0, self.inflight_cost_us - cost_us)
            # a lane past its limit (tokens the lead granted) returns
            # the token instead of handing it on
            if self.waiters and self.inflight <= self.max_inflight:
                w = self._pick_waiter()
                w.granted = True
                self.admitted_total += 1
                if w.cost_us is not None:
                    self.inflight_cost_us += w.cost_us
                # inflight unchanged: the token transfers to the waiter
                self._publish()
                w.event.set()
            else:
                self.inflight -= 1
                self._publish()

    def head_wait_s(self) -> tuple[float, float] | None:
        """(oldest waiter's wait seconds, service EMA seconds), or
        None when the queue is empty — the flight-recorder watchdog's
        queue-head stall signal (utils/flightrec.py)."""
        with self.lock:
            if not self.waiters:
                return None
            oldest = min(self.waiters, key=lambda w: w.seq)
            return (time.monotonic() - oldest.enq_mono,
                    self.service_ema_s)

    def status(self) -> dict:
        with self.lock:
            return {"inflight": self.inflight,
                    "queued": len(self.waiters),
                    "max_inflight": self.max_inflight,
                    "queue_depth": self.queue_depth,
                    "admitted_total": self.admitted_total,
                    "shed_total": self.shed_total,
                    "inflight_predicted_us":
                        round(self.inflight_cost_us, 1),
                    "queued_predicted_us":
                        round(self._queued_cost_us(), 1),
                    "service_ema_ms": round(self.service_ema_s * 1e3,
                                            3)}


class AdmissionController:
    """Separate read/mutate lanes over one Alpha (see module doc)."""

    def __init__(self, max_inflight: int, queue_depth: int):
        self.lanes = {name: _Lane(name, max_inflight, queue_depth)
                      for name in LANES}
        self._tls = threading.local()

    @contextlib.contextmanager
    def admit(self, lane: str, ctx=None, cost_us: float | None = None):
        """Hold one `lane` token for the duration. `cost_us` is the
        scheduler's predicted cost (utils/costprior.py) — None keeps
        the classic count-based behavior. Reentrant per thread: a
        nested server call (an upsert's query leg, a txn read inside a
        continued txn) rides the token its request already holds —
        re-admitting would deadlock a full lane against itself."""
        if getattr(self._tls, "holding", False):
            yield
            return
        ln = self.lanes[lane]
        ln.acquire(ctx, cost_us=cost_us)
        self._tls.holding = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._tls.holding = False
            ln.release(time.perf_counter() - t0, cost_us=cost_us)

    @contextlib.contextmanager
    def follow(self, lane: str, cost_us: float | None = None):
        """Hold a `lane` token the lead granted (see `_Lane.take`), with
        `admit`'s reentrancy: a nested call rides the token its request
        holds."""
        if getattr(self._tls, "holding", False):
            yield
            return
        ln = self.lanes[lane]
        ln.take(cost_us)
        self._tls.holding = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._tls.holding = False
            ln.release(time.perf_counter() - t0, cost_us=cost_us)

    def follow_shed(self, e: ServerOverloaded,
                    cost_us: float | None = None) -> None:
        """Count the lead's shed `e` on its lane (then the caller raises
        it)."""
        self.lanes[e.lane].count_shed(e.reason, cost_us)

    def queued(self) -> int:
        total = 0
        for ln in self.lanes.values():
            with ln.lock:
                total += len(ln.waiters)
        return total

    def saturated(self) -> bool:
        """True while real traffic is queued — the signal maintenance
        yields to at tablet boundaries. Reads the queues under each
        lane's lock: the maintenance thread polls this while request
        threads append and remove waiters."""
        for ln in self.lanes.values():
            with ln.lock:
                if ln.waiters:
                    return True
        return False

    def head_waits(self) -> dict:
        """Per-lane queue-head wait + service EMA (lanes with empty
        queues omitted)."""
        out = {}
        for name, ln in self.lanes.items():
            hw = ln.head_wait_s()
            if hw is not None:
                out[name] = {"wait_s": hw[0], "service_ema_s": hw[1]}
        return out

    def status(self) -> dict:
        return {"lanes": {name: ln.status()
                          for name, ln in self.lanes.items()},
                "queued": self.queued()}
