"""Peer-failure resilience: circuit breakers + budget-aware retries.

Port of `dgraph_tpu/cluster/resilience.py`: `PeerTable`, `BreakerOpen`
and the retry policy, with a plain `threading.Lock`. A breaker
transition is a `breaker.transition` span and a `breaker_state` gauge;
the reference also sends it to its flight recorder, which comes with
ROADMAP Queue 1 item 9f.

Reference parity: the reference rides on grpc-go's connection backoff
plus raft's leader liveness — a dead peer stops being asked because the
raft group re-elects around it, and conn/pool.go health-checks dials.
Our any-coordinator legs (server/task.py `Client._call`) had neither: a
dead peer was an instant terminal error on every call, paid at full
dial-timeout price, forever. This module gives every outbound cluster
RPC a shared health layer:

* **Per-peer circuit breaker** — consecutive transport failures open
  the breaker (closed → open); while open, calls fail INSTANTLY with
  `BreakerOpen` (an UNAVAILABLE-shaped `grpc.RpcError`, so every
  existing `except grpc.RpcError` failover/suspect path treats it as an
  unreachable peer — without burning a wire attempt). After a jittered
  cool-down the breaker goes half-open and admits exactly ONE probe:
  success closes it, failure re-opens with exponentially longer
  cool-down (capped). Concurrent callers during the probe fail fast —
  the retry-storm guard: total wire attempts against a dead peer stay
  bounded no matter how many threads are calling.

* **Budget-aware retry policy** — transient transport failures
  (`UNAVAILABLE`: connect errors, a just-restarting peer, an injected
  `LinkDown`) re-attempt with exponential backoff + jitter. NEVER
  retried: `DEADLINE_EXCEEDED` (the budget died, not the peer),
  application status codes (the peer answered — retrying would double
  apply), or our own `DeadlineExceeded`/`Cancelled`. Backoff sleeps are
  capped by the REMAINING `RequestContext` budget (utils/deadline.py),
  so retries can never outlive the caller's deadline — a retry that
  cannot afford another attempt gives up with the real error.

Observability: `breaker_state{peer=}` gauge (0 closed, 0.5 half-open,
1 open), `rpc_retries_total{rpc=,outcome=}`, per-peer EMA latency and
last error surfaced at `/debug/peers`, and every breaker transition
recorded as a `breaker.transition` span.

One `PeerTable` lives per `Groups` (NOT process-global: in-process
multi-node tests run several Alphas side by side, and node A's view of
peer C must never leak into node B's).
"""

from __future__ import annotations

import random
import threading
import time

import grpc

from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils import tracing
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["BreakerOpen", "PeerTable", "RETRYABLE_CODES"]

# transport-level failure codes worth a retry: the peer may be briefly
# unreachable (connect refused, restarting, link fault). Everything
# else either means "the peer answered" (app errors) or "our budget
# died" (DEADLINE_EXCEEDED) — neither is evidence of a dead peer.
RETRYABLE_CODES = frozenset({grpc.StatusCode.UNAVAILABLE})

_EMA_ALPHA = 0.2  # per-peer latency EMA smoothing


class BreakerOpen(grpc.RpcError):
    """Instant refusal for a peer whose breaker is open — shaped like
    UNAVAILABLE so failover/suspect paths treat it exactly like an
    unreachable peer, minus the wire attempt."""

    def __init__(self, addr: str, retry_in_s: float):
        msg = (f"circuit breaker for peer {addr} is open "
               f"(probe in {max(retry_in_s, 0.0) * 1e3:.0f} ms)")
        super().__init__(msg)
        self._msg = msg

    def code(self):
        return grpc.StatusCode.UNAVAILABLE

    def details(self):
        return self._msg


class _Peer:
    """One peer's health state (guarded by the owning table's lock)."""

    __slots__ = ("state", "fails", "open_until", "open_level", "probing",
                 "ema_us", "last_error", "last_error_mono", "calls",
                 "failures", "opened")

    def __init__(self):
        self.state = "closed"      # closed | open | half_open
        self.fails = 0             # consecutive transport failures
        self.open_until = 0.0      # monotonic end of the cool-down
        self.open_level = 0        # re-open count → cool-down backoff
        self.probing = False       # half-open single-probe token
        self.ema_us = 0.0          # latency EMA of successful calls
        self.last_error = ""
        self.last_error_mono = 0.0
        self.calls = 0
        self.failures = 0
        self.opened = 0


_STATE_GAUGE = {"closed": 0.0, "half_open": 0.5, "open": 1.0}


class PeerTable:
    """Per-node breaker + retry policy over every peer it dials.

    `threshold` consecutive transport failures open a peer's breaker;
    `cooldown_ms` (jittered, doubling per re-open up to
    `max_cooldown_ms`) gates the half-open probe. `retries` is the
    number of RE-attempts a retryable failure earns, with exponential
    backoff from `backoff_ms` capped at `max_backoff_ms` and always by
    the remaining request budget."""

    def __init__(self, threshold: int = 5, cooldown_ms: float = 500.0,
                 retries: int = 2, backoff_ms: float = 10.0,
                 max_backoff_ms: float = 250.0,
                 max_cooldown_ms: float = 30_000.0):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = max(cooldown_ms, 1.0) / 1e3
        self.retries = max(int(retries), 0)
        self.backoff_s = max(backoff_ms, 0.1) / 1e3
        self.max_backoff_s = max(max_backoff_ms, backoff_ms) / 1e3
        self.max_cooldown_s = max(max_cooldown_ms, cooldown_ms) / 1e3
        self._lock = threading.Lock()
        self._peers: dict[str, _Peer] = {}
        self._rng = random.Random(0xD6B2E55)  # jitter only, never schedules

    # -- state machine -------------------------------------------------------
    def _peer(self, addr: str) -> _Peer:
        p = self._peers.get(addr)
        if p is None:
            p = self._peers[addr] = _Peer()
            METRICS.set_gauge("breaker_state", 0.0, peer=addr)
        return p

    def _transition(self, addr: str, p: _Peer, to: str) -> None:
        frm, p.state = p.state, to
        if to == "open":
            p.opened += 1
        METRICS.set_gauge("breaker_state", _STATE_GAUGE[to], peer=addr)
        # transitions are rare; a zero-duration span doubles as the
        # event record (/debug/traces, OTLP export)
        with tracing.span("breaker.transition", peer=addr, frm=frm,
                          to=to, consecutive_failures=p.fails):
            pass

    def acquire(self, addr: str) -> None:
        """Admission gate before a wire attempt; raises `BreakerOpen`
        without touching the wire when the peer is known-dead (open
        inside cool-down, or a half-open probe already in flight)."""
        now = time.monotonic()
        with self._lock:
            p = self._peer(addr)
            p.calls += 1
            if p.state == "open":
                if now < p.open_until:
                    raise BreakerOpen(addr, p.open_until - now)
                self._transition(addr, p, "half_open")
                p.probing = True
            elif p.state == "half_open":
                if p.probing:
                    raise BreakerOpen(addr, 0.0)
                p.probing = True

    def on_success(self, addr: str, latency_s: float | None) -> None:
        """A call reached the peer (a successful response OR an
        application-level status): the peer is alive."""
        with self._lock:
            p = self._peer(addr)
            p.fails = 0
            p.probing = False
            if latency_s is not None:
                us = latency_s * 1e6
                p.ema_us = (us if not p.ema_us
                            else p.ema_us + _EMA_ALPHA * (us - p.ema_us))
            if p.state != "closed":
                p.open_level = 0
                self._transition(addr, p, "closed")

    def on_failure(self, addr: str, err: Exception) -> None:
        """A transport-level failure: count it; open (or re-open with a
        longer cool-down) past the threshold."""
        now = time.monotonic()
        with self._lock:
            p = self._peer(addr)
            p.fails += 1
            p.failures += 1
            p.probing = False
            p.last_error = f"{type(err).__name__}: {err}"[:300]
            p.last_error_mono = now
            reopen = p.state == "half_open"
            if reopen or (p.state == "closed"
                          and p.fails >= self.threshold):
                if reopen:
                    p.open_level += 1
                cd = min(self.cooldown_s * (2 ** p.open_level),
                         self.max_cooldown_s)
                p.open_until = now + cd * self._rng.uniform(1.0, 1.5)
                self._transition(addr, p, "open")

    def reset(self, addr: str) -> None:
        """Forget a peer's health history (a healed fault-injection
        link, an operator reset): next call starts closed."""
        with self._lock:
            if addr in self._peers:
                self._peers[addr] = _Peer()
                METRICS.set_gauge("breaker_state", 0.0, peer=addr)

    def available(self, addr: str) -> bool:
        """Would `acquire` let a call through right now? (Failover uses
        this to order replicas: open-breaker peers go last.)"""
        with self._lock:
            p = self._peers.get(addr)
            if p is None:
                return True
            if p.state == "open":
                return time.monotonic() >= p.open_until
            return True

    def state(self, addr: str) -> str:
        with self._lock:
            p = self._peers.get(addr)
            return p.state if p is not None else "closed"

    # -- the resilient call wrapper -----------------------------------------
    def call(self, addr: str, rpc_name: str, attempt,
             retryable: bool = True):
        """Run `attempt()` against `addr` under the breaker, retrying
        retryable transport failures within the remaining request
        budget. `attempt` performs exactly one wire call."""
        from dgraph_tpu_torch.utils import costprofile
        tries = (self.retries + 1) if retryable else 1
        delay = self.backoff_s
        last: Exception | None = None
        for i in range(tries):
            if i:
                # re-attempts join the request's cost record: a shape
                # whose p99 is retry-dominated names a sick peer set,
                # not an expensive plan
                costprofile.add("rpc_retries", 1)
            self.acquire(addr)
            t0 = time.perf_counter()
            try:
                out = attempt()
            except (dl.DeadlineExceeded, dl.Cancelled):
                # OUR budget died mid-call: says nothing about the peer
                self._release_probe(addr)
                raise
            except grpc.RpcError as e:
                if isinstance(e, BreakerOpen):
                    raise  # a nested guard refused: not a wire failure
                code = e.code() if hasattr(e, "code") else None
                if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                    # never retried: a slow answer is not a dead peer,
                    # and re-spending an expired budget helps nobody
                    self._release_probe(addr)
                    if i:
                        METRICS.inc("rpc_retries_total", rpc=rpc_name,
                                    outcome="failure")
                    raise
                if code not in RETRYABLE_CODES:
                    # application status: the peer answered — alive
                    self.on_success(addr, None)
                    if i:
                        METRICS.inc("rpc_retries_total", rpc=rpc_name,
                                    outcome="success")
                    raise
                self.on_failure(addr, e)
                if i:
                    METRICS.inc("rpc_retries_total", rpc=rpc_name,
                                outcome="failure")
                last = e
                if i + 1 >= tries or not self.available(addr):
                    break  # out of attempts, or the breaker just opened
                sleep = delay * self._rng.uniform(1.0, 1.25)
                rem = dl.remaining_s()
                if rem is not None:
                    if rem <= 0.002:
                        break  # the budget cannot afford another try
                    sleep = min(sleep, max(rem - 0.001, 0.0))
                time.sleep(sleep)
                delay = min(delay * 2, self.max_backoff_s)
                continue
            except BaseException:
                # anything unexpected (serialization bug, interrupt):
                # the half-open probe token must not stay held, or the
                # breaker wedges permanently half-open
                self._release_probe(addr)
                raise
            self.on_success(addr, time.perf_counter() - t0)
            if i:
                METRICS.inc("rpc_retries_total", rpc=rpc_name,
                            outcome="success")
            return out
        raise last

    def _release_probe(self, addr: str) -> None:
        with self._lock:
            p = self._peers.get(addr)
            if p is not None:
                p.probing = False

    # -- surfacing -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Per-peer health for `/debug/peers`."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for addr, p in sorted(self._peers.items()):
                out[addr] = {
                    "state": p.state,
                    "consecutive_failures": p.fails,
                    "ema_latency_us": round(p.ema_us, 1),
                    "calls_total": p.calls,
                    "failures_total": p.failures,
                    "opened_total": p.opened,
                    "last_error": p.last_error,
                    "last_error_age_s": (
                        round(now - p.last_error_mono, 3)
                        if p.last_error else None),
                    "cooldown_remaining_s": (
                        round(max(p.open_until - now, 0.0), 3)
                        if p.state == "open" else 0.0),
                }
            return out
