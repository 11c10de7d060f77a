"""Request lifecycle: deadlines + cooperative cancellation.

Port of `dgraph_tpu/utils/deadline.py`. On the card a checkpoint reads
the HOST clock: kernels and CUDA graph replays are asynchronous, so a
budget bounds the host loop that issues them, and device work already
queued when the budget expires runs to its end. Reference parity: the reference enforces request lifecycles with Go
`context.Context` — every `worker.Task` gRPC leg carries a deadline, and
a query that outlives it is cancelled cooperatively at loop boundaries
(`ctx.Err()` checks in ProcessGraph / processTask). Python has no
ambient context, so this module provides one: a `RequestContext` with a
MONOTONIC deadline and a thread-safe cancel flag, installed thread-local
by the serving layer (`Alpha._request`) and consulted by `checkpoint()`
calls in the hot loops — level expansions, BFS iterations, kernel-group
launches, cluster RPC legs.

Checkpoint granularity is one level / one BFS iteration / one RPC: a
pathological `@recurse` or shortest-path query stops within one loop
body of its budget instead of holding the Alpha until it finishes.
Everything a cancelled request held (read registrations, admission
tokens, fold gates) is released by the enclosing `with`/`finally`
blocks it raises through — cancellation is an exception, never a
thread kill.

`of_thread` finds the context another thread is running under: the HTTP
front end's disconnect watcher (server/http.py) cancels through it.
A cluster RPC's leg forwards the remaining budget as its gRPC timeout
(server/task.py `Client._attempt`).

Both `DeadlineExceeded` and `Cancelled` are RETRYABLE by contract: the
server refused to spend more than the client's budget; nothing
half-applied (the mutate path checkpoints only BEFORE the WAL append —
interrupting between the append and the in-memory apply would leave a
logged commit unapplied until the next replay).
"""

from __future__ import annotations

import contextlib
import threading
import time

from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["RequestContext", "DeadlineExceeded", "Cancelled",
           "current", "activate", "checkpoint", "remaining_s",
           "monotonic_s", "of_thread"]


def monotonic_s() -> float:
    """The package's one clock for deadline, backoff and elapsed
    arithmetic: NTP steps and DST never move a budget. The wall clock
    (`time.time`) is kept for timestamps that leave the process (span
    epochs, token expiry read by another process)."""
    return time.monotonic()


class DeadlineExceeded(Exception):
    """RETRYABLE: the request's time budget expired mid-flight. The
    partially-done work was discarded cleanly (no leaked read
    registrations, pends, or admission tokens); retry with a larger
    budget."""

    def __init__(self, msg: str, stage: str = ""):
        super().__init__(msg)
        self.stage = stage


class Cancelled(Exception):
    """RETRYABLE: the client cancelled the request (connection drop,
    explicit cancel). Same cleanup contract as DeadlineExceeded."""

    def __init__(self, msg: str, stage: str = ""):
        super().__init__(msg)
        self.stage = stage


class RequestContext:
    """One request's budget: monotonic deadline + cancel flag.

    `deadline_ms=None` (or 0) means unbounded — `check()` then only
    honors the cancel flag. The cancel flag is an Event so any thread
    (an HTTP handler noticing a closed socket, an operator endpoint)
    can cancel a request executing elsewhere."""

    __slots__ = ("started", "deadline", "_cancel")

    def __init__(self, deadline_ms: float | None = None):
        self.started = time.monotonic()
        self.deadline = (self.started + deadline_ms / 1e3
                         if deadline_ms else None)
        self._cancel = threading.Event()

    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def remaining_s(self) -> float | None:
        """Seconds of budget left (None = unbounded; ≤ 0 = expired).
        This is what outbound RPC legs forward to peers."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def remaining_ms(self) -> float | None:
        r = self.remaining_s()
        return None if r is None else r * 1e3

    def expired(self) -> bool:
        return (self.deadline is not None
                and time.monotonic() >= self.deadline)

    def consume(self, seconds: float) -> None:
        """VIRTUALLY advance this request's clock by `seconds`: the
        deadline moves earlier by exactly that much, so budget
        arithmetic (checkpoints, RPC timeout forwarding, admission
        waits) behaves as if the time had really passed — without any
        wall-clock sleep. This is the clock-free delay-fault primitive
        (cluster/fault.py): a fuzzed 30 ms link stall costs the fuzz
        run zero wall time but still expires tight budgets exactly
        like a real stall. Unbounded contexts have no budget to
        consume; the caller's drop counter still records the event."""
        if self.deadline is not None and seconds > 0:
            self.deadline -= seconds

    def check(self, stage: str = "") -> None:
        """Raise (retryably) if the budget is gone — the cooperative
        cancellation point. Metrics label the STAGE that noticed, so an
        overrunning workload names its hot loop."""
        if self._cancel.is_set():
            METRICS.inc("request_cancelled_total", stage=stage)
            raise Cancelled(f"request cancelled at stage "
                            f"{stage or 'unknown'}", stage=stage)
        if self.deadline is not None:
            now = time.monotonic()
            if now >= self.deadline:
                METRICS.inc("deadline_exceeded_total", stage=stage)
                raise DeadlineExceeded(
                    f"deadline exceeded at stage {stage or 'unknown'} "
                    f"({(now - self.started) * 1e3:.1f} ms elapsed, "
                    f"budget "
                    f"{(self.deadline - self.started) * 1e3:.1f} ms); "
                    f"retry with a larger deadline", stage=stage)


_TLS = threading.local()
# thread ident -> active context, for cancelling from another thread (a
# connection watcher that sees a closed socket cancels the context its
# handler thread is running under). One store and one pop per request,
# each atomic in CPython.
_ACTIVE: dict[int, RequestContext] = {}


def current() -> RequestContext | None:
    """The thread's active RequestContext (None outside any request)."""
    return getattr(_TLS, "ctx", None)


def of_thread(ident: int) -> RequestContext | None:
    """The active RequestContext of another thread (None when that
    thread is not inside a request); `ctx.cancel()` is thread-safe."""
    return _ACTIVE.get(ident)


@contextlib.contextmanager
def activate(ctx: RequestContext):
    """Install `ctx` as the thread's ambient request context."""
    prev = getattr(_TLS, "ctx", None)
    ident = threading.get_ident()
    _TLS.ctx = ctx
    _ACTIVE[ident] = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev
        if prev is None:
            _ACTIVE.pop(ident, None)
        else:
            _ACTIVE[ident] = prev


def checkpoint(stage: str = "") -> None:
    """Cooperative cancellation point for hot loops: one thread-local
    load + None check when no request context is active (the
    observability-overhead bar applies here too — tier-1 guards the
    uncontended path at <5%)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is not None:
        ctx.check(stage)


def remaining_s() -> float | None:
    """Remaining budget of the ambient context (None = unbounded or no
    context)."""
    ctx = getattr(_TLS, "ctx", None)
    return None if ctx is None else ctx.remaining_s()
