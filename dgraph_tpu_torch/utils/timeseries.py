"""Retained metrics history: the sampler daemon + windowed-point ring.

Port of `dgraph_tpu/utils/timeseries.py`. A daemon thread samples the
metrics `Registry` every `interval_s` into a bounded ring of WINDOWED
points — counters become rates (delta/dt), gauges values, histograms
per-window bucket deltas with interpolated p50/p90/p99 — and serves
windows of that history to `/debug/timeseries`, the SLO engine's burn
rates (`utils/slo.py`), flight bundles (the "timeseries" surface: the
approach, not just the crash), the fleet merge, and the Holt-trend load
forecast behind admission's forecast shedding.

The ring is a governed cache: it registers as `timeseries.ring` with
the memory governor (host kind), so under budget pressure the OLDEST
history goes first (`ts_ring_dropped_total` counts both bound and
governor drops). Timestamps are monotonic; consumers see `age_s`.

The sampler reads the registry from its own thread and never touches
the card. An unarmed process pays one module-global load and a None
check at the admission probe, and nothing on the query path.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from dgraph_tpu_torch.utils import locks
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["Ring", "Window", "Forecast", "Sampler", "arm", "disarm",
           "state", "status", "recent_window", "forecast_probe",
           "DEFAULT_INTERVAL_S", "DEFAULT_RING_POINTS"]

DEFAULT_INTERVAL_S = 1.0
DEFAULT_RING_POINTS = 3600        # 1h of history at the default cadence

# rough per-entry byte estimate for the governor's accounting: budgets
# need relative truth, not an audit (memgov.estimate_nbytes is too slow
# to run per tick)
_ENTRY_BYTES = 48
_POINT_BYTES = 160

# Holt (double-exponential) trend smoothing for the arrival-rate
# forecast, and the demand margin past which admission sheds ahead of
# the queue filling (Little's law: demand = rate × cost)
_HOLT_ALPHA = 0.5
_HOLT_BETA = 0.3
_FORECAST_HORIZON_S = 30.0
_FORECAST_MARGIN = 2.0


def _percentile(buckets: tuple, counts: list, n: float, q: float) -> float:
    """Deterministic bucket-interpolated percentile: rank q·n located in
    the cumulative counts, linearly interpolated inside its bucket. The
    +Inf slot clamps to the top finite bound (no invented tail)."""
    if n <= 0:
        return 0.0
    rank = q * n
    acc = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        lo = float(buckets[i - 1]) if i > 0 else 0.0
        hi = float(buckets[i]) if i < len(buckets) else float(buckets[-1])
        if acc + c >= rank:
            frac = min(max((rank - acc) / c, 0.0), 1.0)
            return lo + (hi - lo) * frac
        acc += c
    return float(buckets[-1])


class Window:
    """A slice of ring points covering the last `seconds` — the view
    the SLO evaluators and debug endpoints aggregate over."""

    def __init__(self, points: list, span_s: float):
        self.points = points
        self.span_s = span_s

    def delta(self, prefix: str) -> float:
        """Summed counter increments across series matching `prefix`
        (rendered-name prefix: `shed_total` matches every label set)."""
        total = 0.0
        for p in self.points:
            for name, d in p["deltas"].items():
                if name.startswith(prefix):
                    total += d
        return total

    def rate(self, prefix: str) -> float:
        return self.delta(prefix) / self.span_s if self.span_s else 0.0

    def hist(self, prefix: str) -> dict:
        """Merged windowed histogram across matching series: summed
        bucket deltas + n + sum over the window."""
        buckets: tuple = ()
        counts: list = []
        n = 0.0
        total = 0.0
        for p in self.points:
            for name, h in p["hists"].items():
                if not name.startswith(prefix):
                    continue
                if not counts:
                    buckets = h["buckets"]
                    counts = [0.0] * len(h["counts"])
                for i, c in enumerate(h["counts"]):
                    counts[i] += c
                n += h["n"]
                total += h["sum"]
        return {"buckets": buckets, "counts": counts, "n": n,
                "sum": total}

    def hist_n(self, prefix: str) -> float:
        return self.hist(prefix)["n"]

    def frac_above(self, prefix: str, threshold: float):
        """(bad, total): windowed observations whose bucket's upper
        bound exceeds `threshold` — the latency-SLO bad-event count.
        Conservative at bucket granularity, deterministic always."""
        h = self.hist(prefix)
        bad = 0.0
        for i, c in enumerate(h["counts"]):
            hi = (float(h["buckets"][i]) if i < len(h["buckets"])
                  else float("inf"))
            if hi > threshold:
                bad += c
        return bad, h["n"]

    def percentile(self, prefix: str, q: float) -> float:
        h = self.hist(prefix)
        return _percentile(h["buckets"], h["counts"], h["n"], q)


class Ring:
    """The bounded, governed point ring. `sample()` diffs the registry
    against the previous snapshot; everything derived (rates, windowed
    percentiles) is computed once at sample time so reads are cheap."""

    def __init__(self, points: int = DEFAULT_RING_POINTS,
                 registry=METRICS):
        self.capacity = max(2, int(points))
        self.registry = registry
        self._lock = locks.make_lock("timeseries.ring")
        self._points: deque = deque()
        self._prev_counters: dict = {}
        self._prev_hists: dict = {}
        self._prev_t: float | None = None
        self._bytes = 0
        self.points_total = 0
        self.dropped_total = 0
        locks.guarded(self, "timeseries.ring")
        from dgraph_tpu_torch.utils import memgov
        self._gov_id = memgov.GOVERNOR.register(
            "timeseries.ring", "host", self._resident_bytes,
            self._evict_one, owner=self)

    # -- governor callbacks ----------------------------------------------

    def _resident_bytes(self) -> int:
        return self._bytes

    def _evict_one(self) -> int:
        """Surrender the oldest 1/16th of retained history (at least
        one point) — the governor's unit of progress."""
        with self._lock:
            k = min(len(self._points), max(1, self.capacity // 16))
            freed = 0
            for _ in range(k):
                freed += self._pop_oldest_locked()
        if k:
            METRICS.inc("ts_ring_dropped_total", value=float(k),
                        reason="memgov")
        return freed

    def _pop_oldest_locked(self) -> int:
        p = self._points.popleft()
        b = p["_bytes"]
        self._bytes -= b
        self.dropped_total += 1
        return b

    # -- sampling ---------------------------------------------------------

    def sample(self, now: float | None = None) -> dict | None:
        """Take one windowed point (the sampler tick; tests call it
        directly with explicit `now` for determinism). The first call
        baselines and retains nothing — a delta needs two snapshots."""
        snap = self.registry.snapshot()
        hists = self.registry.hist_snapshot()
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            prev_c, prev_h = self._prev_counters, self._prev_hists
            first = self._prev_t is None
            dt = 0.0 if first else max(t - self._prev_t, 1e-9)
            self._prev_counters = snap["counters"]
            self._prev_hists = hists
            self._prev_t = t
            if first:
                return None
            deltas, rates = {}, {}
            for name, v in snap["counters"].items():
                d = v - prev_c.get(name, 0.0)
                if d:
                    deltas[name] = d
                    rates[name] = d / dt
            hp = {}
            for name, h in hists.items():
                ph = prev_h.get(name)
                pc = ph["counts"] if ph else [0] * len(h["counts"])
                dcounts = [c - p for c, p in zip(h["counts"], pc)]
                dn = h["n"] - (ph["n"] if ph else 0)
                if dn <= 0:
                    continue
                bks = h["buckets"]
                hp[name] = {
                    "buckets": bks, "counts": dcounts, "n": dn,
                    "sum": h["sum"] - (ph["sum"] if ph else 0.0),
                    "p50": _percentile(bks, dcounts, dn, 0.50),
                    "p90": _percentile(bks, dcounts, dn, 0.90),
                    "p99": _percentile(bks, dcounts, dn, 0.99)}
            nbytes = (_POINT_BYTES
                      + _ENTRY_BYTES * (len(deltas) * 2
                                        + len(snap["gauges"]))
                      + sum(_ENTRY_BYTES + 8 * len(h["counts"])
                            for h in hp.values()))
            point = {"t": t, "dt": dt, "deltas": deltas, "rates": rates,
                     "gauges": dict(snap["gauges"]), "hists": hp,
                     "_bytes": nbytes}
            bound_drops = 0
            while len(self._points) >= self.capacity:
                self._pop_oldest_locked()
                bound_drops += 1
            self._points.append(point)
            self._bytes += nbytes
            self.points_total += 1
        METRICS.inc("ts_points_total")
        if bound_drops:
            METRICS.inc("ts_ring_dropped_total",
                        value=float(bound_drops), reason="bound")
        from dgraph_tpu_torch.utils import memgov
        memgov.GOVERNOR.maybe_evict("host")
        return point

    # -- reads ------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._points)

    def window(self, seconds: float, now: float | None = None) -> Window:
        with self._lock:
            if not self._points:
                return Window([], 0.0)
            end = self._points[-1]["t"] if now is None else float(now)
            lo = end - float(seconds)
            pts = [p for p in self._points if p["t"] > lo]
            span = (pts[-1]["t"] - pts[0]["t"] + pts[0]["dt"]
                    if pts else 0.0)
            return Window(pts, span)

    def series_names(self) -> dict:
        """Available series by kind, from the newest point."""
        with self._lock:
            if not self._points:
                return {"rates": [], "gauges": [], "hists": []}
            p = self._points[-1]
            return {"rates": sorted(p["rates"]),
                    "gauges": sorted(p["gauges"]),
                    "hists": sorted(p["hists"])}

    def series(self, name: str, window_s: float | None = None,
               rate: bool = True, now: float | None = None) -> dict:
        """Point list for every series matching `name` (prefix) —
        the ?name= view of /debug/timeseries. Counter series serve
        rates (or raw deltas with rate=false); histograms serve the
        windowed percentiles; gauges serve values."""
        with self._lock:
            pts = list(self._points)
        if not pts:
            return {"series": {}, "points": 0}
        end = pts[-1]["t"] if now is None else float(now)
        if window_s:
            pts = [p for p in pts if p["t"] > end - float(window_s)]
        out: dict[str, list] = {}
        for p in pts:
            age = round(end - p["t"], 3)
            table = p["rates"] if rate else p["deltas"]
            for sname, v in table.items():
                if sname.startswith(name):
                    out.setdefault(sname, []).append(
                        {"age_s": age, "value": round(v, 6)})
            for sname, v in p["gauges"].items():
                if sname.startswith(name):
                    out.setdefault(sname, []).append(
                        {"age_s": age, "value": v})
            for sname, h in p["hists"].items():
                if sname.startswith(name):
                    out.setdefault(sname, []).append(
                        {"age_s": age, "n": h["n"],
                         "p50": round(h["p50"], 1),
                         "p90": round(h["p90"], 1),
                         "p99": round(h["p99"], 1)})
        return {"series": out, "points": len(pts)}

    def summary(self, window_s: float = 60.0) -> dict:
        """Compact recent-history digest: ring occupancy + the last
        window's top rates and latency percentiles — what the fleet
        merge carries."""
        w = self.window(window_s)
        rates: dict[str, float] = {}
        for p in w.points:
            for name, d in p["deltas"].items():
                rates[name] = rates.get(name, 0.0) + d
        span = w.span_s or 1.0
        top = {k: round(v / span, 3) for k, v in
               sorted(rates.items(), key=lambda kv: -kv[1])[:8]}
        lat = w.hist("query_latency_us")
        return {"points": len(self), "points_total": self.points_total,
                "dropped_total": self.dropped_total,
                "resident_bytes": self._bytes,
                "window_s": round(span, 3),
                "top_rates": top,
                "query_latency": {
                    "n": lat["n"],
                    "p50_us": round(_percentile(
                        lat["buckets"], lat["counts"], lat["n"], 0.5), 1),
                    "p99_us": round(_percentile(
                        lat["buckets"], lat["counts"], lat["n"], 0.99), 1),
                } if lat["n"] else None}


class Forecast:
    """Holt double-exponential trend over per-lane arrival rates; the
    admission probe sheds when predicted demand (forecast arrivals/s ×
    predicted cost, Little's law) exceeds `margin` × the lane's
    tokens. Deterministic given the update sequence."""

    def __init__(self, alpha: float = _HOLT_ALPHA,
                 beta: float = _HOLT_BETA,
                 horizon_s: float = _FORECAST_HORIZON_S,
                 margin: float = _FORECAST_MARGIN):
        self.alpha = alpha
        self.beta = beta
        self.horizon_s = horizon_s
        self.margin = margin
        self._lock = locks.make_lock("timeseries.forecast")
        self._level: dict[str, float] = {}
        self._trend: dict[str, float] = {}
        self.sheds = 0
        locks.guarded(self, "timeseries.forecast")

    def update(self, lane: str, rate: float, dt: float = 1.0) -> None:
        """One sampled arrival rate (requests/s) for `lane`; trend is
        kept in per-second units so the horizon is cadence-free."""
        with self._lock:
            if lane not in self._level:
                self._level[lane] = rate
                self._trend[lane] = 0.0
                return
            prev = self._level[lane]
            level = (self.alpha * rate
                     + (1.0 - self.alpha) * (prev + self._trend[lane] * dt))
            self._trend[lane] = (self.beta * (level - prev) / max(dt, 1e-9)
                                 + (1.0 - self.beta) * self._trend[lane])
            self._level[lane] = level

    def predicted_rate(self, lane: str) -> float:
        with self._lock:
            if lane not in self._level:
                return 0.0
            return max(0.0, self._level[lane]
                       + self._trend[lane] * self.horizon_s)

    def predicted_demand(self, lane: str, cost_us: float) -> float:
        """Expected concurrent requests at the horizon: λ × W."""
        return self.predicted_rate(lane) * max(cost_us, 0.0) / 1e6

    def should_shed(self, lane: str, cost_us: float | None,
                    max_inflight: int) -> bool:
        """True when admitting more of this lane's arrivals is
        predicted to exceed `margin` × its tokens before the horizon —
        shed NOW, while the hint is still short, instead of after the
        queue fills. Requests with no predicted cost fall back to the
        lane's prior EMA; no signal at all never sheds."""
        cost = cost_us
        if cost is None:
            try:
                from dgraph_tpu_torch.utils import costprior
                cost = costprior.lane_ema_us(lane)
            except Exception:
                cost = None
        if not cost:
            return False
        demand = self.predicted_demand(lane, cost)
        if demand <= self.margin * max(max_inflight, 1):
            return False
        with self._lock:
            self.sheds += 1
        return True

    def status(self) -> dict:
        with self._lock:
            return {"lanes": {lane: {
                        "level": round(self._level[lane], 4),
                        "trend_per_s": round(self._trend[lane], 6),
                    } for lane in sorted(self._level)},
                    "horizon_s": self.horizon_s,
                    "margin": self.margin,
                    "sheds": self.sheds}


class Sampler:
    """The daemon: one tick per `interval_s` — sample the ring, update
    the forecast from the lane arrival counters, evaluate the SLO
    engine. Mirrors the flight watchdog's loop discipline (daemon
    thread, Event stop, exception-swallowing tick)."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 ring: Ring | None = None, engine=None,
                 forecast: Forecast | None = None, registry=METRICS):
        self.interval_s = max(float(interval_s), 0.01)
        self.ring = ring if ring is not None else Ring(registry=registry)
        self.engine = engine
        self.forecast = forecast
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self, now: float | None = None) -> dict | None:
        point = self.ring.sample(now=now)
        if point is not None and self.forecast is not None:
            for lane in ("read", "mutate"):
                series = f'admission_requests_total{{lane="{lane}"}}'
                self.forecast.update(lane,
                                     point["rates"].get(series, 0.0),
                                     dt=point["dt"])
        if self.engine is not None:
            self.engine.evaluate(self.ring, now=now)
        return point

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                from dgraph_tpu_torch.utils import logging as xlog
                xlog.get("timeseries").exception("sampler tick failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="ts-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def status(self) -> dict:
        doc = {"interval_s": self.interval_s,
               "running": self._thread is not None,
               "ring": self.ring.summary()}
        if self.forecast is not None:
            doc["forecast"] = self.forecast.status()
        return doc


# the armed sampler + forecaster (None = disarmed). The admission
# probe reads `_FORECAST` with one global load + None check — the
# off-path cost when forecast shedding is disabled.
_STATE: Sampler | None = None
_FORECAST: Forecast | None = None


def arm(*, interval_s: float = DEFAULT_INTERVAL_S,
        ring_points: int = DEFAULT_RING_POINTS, slo_engine=None,
        forecast: bool = True, registry=METRICS,
        start_thread: bool = True) -> Sampler:
    """Arm the sampler (idempotent: re-arming replaces). `slo_engine`
    also installs as slo.ENGINE so the watchdog and /debug/slo see it;
    `forecast=False` leaves the admission off-path bit-identical."""
    global _STATE, _FORECAST
    disarm()
    fc = Forecast() if forecast else None
    s = Sampler(interval_s=interval_s,
                ring=Ring(points=ring_points, registry=registry),
                engine=slo_engine, forecast=fc, registry=registry)
    if slo_engine is not None:
        from dgraph_tpu_torch.utils import slo as _slo
        _slo.install(slo_engine)
    _STATE = s
    _FORECAST = fc
    if start_thread:
        s.start()
    return s


def disarm() -> None:
    global _STATE, _FORECAST
    s = _STATE
    _STATE = None
    _FORECAST = None
    if s is not None:
        s.stop()
        if s.engine is not None:
            from dgraph_tpu_torch.utils import slo as _slo
            if _slo.ENGINE is s.engine:
                _slo.uninstall()


def state() -> Sampler | None:
    return _STATE


def forecast_probe(lane: str, cost_us: float | None,
                   max_inflight: int) -> bool:
    """The admission fast probe: disarmed processes pay one global
    load + None check."""
    fc = _FORECAST
    if fc is None:
        return False
    return fc.should_shed(lane, cost_us, max_inflight)


def status(name: str | None = None, window_s: float | None = None,
           rate: bool = True) -> dict:
    """The /debug/timeseries document."""
    s = _STATE
    if s is None:
        return {"armed": False}
    doc = {"armed": True, **s.status()}
    if name:
        doc.update(s.ring.series(name, window_s=window_s, rate=rate))
    else:
        doc["names"] = s.ring.series_names()
    return doc


def recent_window(seconds: float = 300.0) -> dict | None:
    """The flight-bundle "timeseries" surface: the last `seconds` of
    retained history leading up to the dump — per-series rates and
    latency percentiles, newest last."""
    s = _STATE
    if s is None or not len(s.ring):
        return None
    w = s.ring.window(seconds)
    end = w.points[-1]["t"] if w.points else 0.0
    pts = []
    for p in w.points:
        pts.append({
            "age_s": round(end - p["t"], 3),
            "rates": {k: round(v, 4) for k, v in p["rates"].items()},
            "gauges": p["gauges"],
            "hists": {k: {"n": h["n"], "p50": round(h["p50"], 1),
                          "p90": round(h["p90"], 1),
                          "p99": round(h["p99"], 1)}
                      for k, h in p["hists"].items()}})
    doc = {"window_s": round(w.span_s, 3), "points": pts,
           "summary": s.ring.summary(seconds)}
    if s.engine is not None:
        doc["slo"] = s.engine.status()["states"]
    return doc
