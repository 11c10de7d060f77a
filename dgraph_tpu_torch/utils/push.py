"""Live telemetry push: spans + cost records → an OTLP collector.

Port of `dgraph_tpu/utils/push.py`. A `TelemetryPusher` subscribes to
the span registry (`tracing.add_sink`) and the cost-record stream
(`costprofile.add_sink`), buffers bounded, and a background thread POSTs
batches to the collector:

  * spans      → `<url>/v1/traces` as OTLP/JSON (`tracing.to_otlp`)
  * cost recs  → `<url>/v1/costs`  as `{"records": [...]}` JSON

Contracts:
  * never blocks the request path: the sink appends under a lock; a
    full buffer drops the OLDEST entry and counts
    `telemetry_dropped_total{kind=}`.
  * retry with backoff: a failed POST re-queues its batch at the front
    (oldest-first order kept), doubles the delay (capped), and counts
    `telemetry_push_total{outcome="error"}`; successes count
    `outcome="ok"`.
  * the flight recorder's watchdog reads `status()` to convict a wedged
    pusher (a stale cycle stamp with a non-empty buffer).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

from dgraph_tpu_torch.utils import costprofile, locks, tracing
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["TelemetryPusher"]

_BACKOFF_BASE_S = 0.5
_BACKOFF_CAP_S = 30.0


class TelemetryPusher:
    """Background exporter thread with a bounded two-stream buffer."""

    def __init__(self, url: str, interval_s: float = 5.0,
                 buffer_max: int = 2048, batch_max: int = 256,
                 timeout_s: float = 2.0):
        self.url = url.rstrip("/")
        self.interval_s = max(float(interval_s), 0.05)
        self.buffer_max = int(buffer_max)
        self.batch_max = int(batch_max)
        self.timeout_s = float(timeout_s)
        self._spans: list = []
        self._costs: list = []
        self._lock = locks.make_lock("push.buffer")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._backoff_s = 0.0
        # exporter-loop liveness for the flight-recorder watchdog: the
        # loop stamps this every cycle; a stale stamp with a non-empty
        # buffer means the pusher wedged (utils/flightrec.py)
        self._last_cycle_mono = time.monotonic()
        locks.guarded(self, "push.buffer")

    # -- request-path sinks (must stay cheap + non-blocking) -----------------
    def _offer(self, buf: list, kind: str, item) -> None:
        with self._lock:
            if len(buf) >= self.buffer_max:
                del buf[0]
                METRICS.inc("telemetry_dropped_total", kind=kind)
            buf.append(item)

    def offer_span(self, span) -> None:
        self._offer(self._spans, "span", span)

    def offer_cost(self, record: dict) -> None:
        self._offer(self._costs, "cost", record)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "TelemetryPusher":
        tracing.add_sink(self.offer_span)
        costprofile.add_sink(self.offer_cost)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-push")
        self._thread.start()
        return self

    def stop(self, flush: bool = True) -> None:
        """Unsubscribe and stop; `flush=True` attempts one final push
        of whatever is buffered (best effort — shutdown never hangs on
        a dead collector beyond one POST timeout per stream)."""
        tracing.remove_sink(self.offer_span)
        costprofile.remove_sink(self.offer_cost)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s * 3)
        if flush:
            self._push_once()

    # -- exporter loop --------------------------------------------------------
    def _run(self) -> None:
        while True:
            # backoff is written by this thread on push failure and
            # read by status() on HTTP threads: all accesses ride the
            # buffer lock
            with self._lock:
                delay = self._backoff_s or self.interval_s
                self._last_cycle_mono = time.monotonic()
            if self._stop.wait(delay):
                return
            self._push_once()
            with self._lock:
                self._last_cycle_mono = time.monotonic()

    def _take(self) -> tuple[list, list]:
        with self._lock:
            spans = self._spans[: self.batch_max]
            del self._spans[: len(spans)]
            costs = self._costs[: self.batch_max]
            del self._costs[: len(costs)]
        return spans, costs

    def _requeue(self, buf: list, kind: str, batch: list) -> None:
        """Put a failed batch back at the FRONT (order preserved);
        entries that no longer fit drop, counted."""
        with self._lock:
            room = self.buffer_max - len(buf)
            if room < len(batch):
                METRICS.inc("telemetry_dropped_total",
                            float(len(batch) - max(room, 0)), kind=kind)
                batch = batch[len(batch) - max(room, 0):]
            buf[:0] = batch

    def _push_once(self) -> None:
        spans, costs = self._take()
        if not spans and not costs:
            return
        try:
            if spans:
                self._post("/v1/traces", tracing.to_otlp(spans))
            if costs:
                self._post("/v1/costs", {"records": costs})
            METRICS.inc("telemetry_push_total", outcome="ok")
            with self._lock:
                self._backoff_s = 0.0
        except Exception:  # noqa: BLE001 — collector down ≠ serving down
            METRICS.inc("telemetry_push_total", outcome="error")
            self._requeue(self._spans, "span", spans)
            self._requeue(self._costs, "cost", costs)
            with self._lock:
                self._backoff_s = min(
                    _BACKOFF_CAP_S,
                    (self._backoff_s or _BACKOFF_BASE_S) * 2)

    def _post(self, path: str, doc: dict) -> None:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        # graftlint: allow(direct-io): telemetry export to an EXTERNAL
        # collector, not a cluster RPC — it must not ride the peer
        # breaker/retry wrapper; this loop has its own bounded
        # retry/backoff/drop policy
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            r.read()

    def status(self) -> dict:
        alive = self._thread is not None and self._thread.is_alive()
        with self._lock:
            return {"url": self.url, "interval_s": self.interval_s,
                    "buffered_spans": len(self._spans),
                    "buffered_costs": len(self._costs),
                    "backoff_s": self._backoff_s,
                    "alive": alive,
                    "last_cycle_age_s": round(
                        time.monotonic() - self._last_cycle_mono, 3)}
