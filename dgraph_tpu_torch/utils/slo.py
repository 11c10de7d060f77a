"""Declarative SLOs evaluated with multi-window burn rates.

Port of `dgraph_tpu/utils/slo.py`. Each SLO names an objective (a
per-lane latency target, an error-rate budget, a shed-rate budget), and
the engine evaluates its BURN RATE — the fraction of the error budget
consumed per unit time — over the time-series ring's fast (~5 min) and
slow (~1 h) windows at once (both scaled down by tests). A fast-window
burn above its threshold is a breach: `slo_breaches_total{slo=,window=}`
and a `slo.breach` flight event carrying an exemplar trace id from the
slow-query ring; sustained across `SUSTAIN_EVALS` evaluations it is a
watchdog conviction (kind=slo). The slow window catches the quiet bleed
a fast spike never shows.

`SLO_SPECS` is the static inventory of every SLO the engine evaluates;
the evaluator registry refuses names outside it. The exemplar lookup
and the flight event import lazily, at breach time.
"""

from __future__ import annotations

from dgraph_tpu_torch.utils import locks
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["SLO_SPECS", "DEFAULT_TARGETS", "SloEngine", "parse_spec",
           "install", "uninstall", "ENGINE",
           "FAST_WINDOW_S", "SLOW_WINDOW_S", "FAST_BURN", "SLOW_BURN"]

# ---------------------------------------------------------------------------
# static inventory: every SLO the engine can evaluate, by name.
# the runtime evaluator registry covers exactly these names, so an
# alerting objective cannot ship undocumented (as memgov.GOVERNED_CACHES).

SLO_SPECS: dict[str, str] = {
    "read_latency_p99_us": "p99 latency objective for read-lane queries "
                           "(µs target over the query_latency_us "
                           "histogram; 1% of requests may exceed it)",
    "mutate_latency_p99_us": "p99 latency objective for mutations (µs "
                             "target over the mutation leg of the "
                             "query_latency_us histogram)",
    "error_rate": "fraction of served requests that errored "
                  "(query_errors_total over the request total) the "
                  "budget tolerates before burning",
    "shed_rate": "fraction of admission arrivals shed "
                 "(shed_total over admission_requests_total) — load "
                 "shedding is budgeted, not free",
    "graphrag_read_p99": "p99 latency objective for GraphRAG retrieval "
                         "blocks — similar_to-seeded queries, any route "
                         "(µs target over the graphrag_latency_us "
                         "histogram; 1% may exceed it)",
}

# default objectives (overridable per-name via --slo_spec superflag):
# latency targets in µs; rate SLOs as allowed bad fractions
DEFAULT_TARGETS: dict[str, float] = {
    "read_latency_p99_us": 100_000.0,
    "mutate_latency_p99_us": 250_000.0,
    "error_rate": 0.01,
    "shed_rate": 0.05,
    "graphrag_read_p99": 150_000.0,
}

# a pN latency SLO tolerates (100-N)% of requests over target — the
# bad-fraction budget burn rates are computed against
_LATENCY_BUDGET = 0.01

# Google-SRE multi-window defaults: a fast 5-minute window paging at
# 14× burn (budget gone in ~2 days at that pace) and a slow 1-hour
# window ticketing at 2× — both scaled down by tests via the ctor
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
FAST_BURN = 14.0
SLOW_BURN = 2.0
# consecutive fast-breached evaluations before the watchdog may
# convict (kind=slo) — one spiky window is a page, not a conviction
SUSTAIN_EVALS = 3


def parse_spec(s: str) -> dict[str, float]:
    """`--slo_spec` superflag → per-name target overrides. Unknown SLO
    names are REJECTED (a typo must not silently leave the default
    budget in force)."""
    out: dict[str, float] = {}
    for k, v in parse_superflag(s or "").items():
        if k not in SLO_SPECS:
            raise ValueError(f"unknown SLO {k!r} — add it to "
                             f"slo.SLO_SPECS")
        out[k] = float(v)
    return out


def parse_superflag(s: str) -> dict[str, str]:
    """'a=1; b=x' → {'a': '1', 'b': 'x'} (the reference's
    `utils/config.parse_superflag`, which comes to the port with its
    CLI)."""
    out = {}
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"superflag needs key=value, got {part!r}")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out


# ---------------------------------------------------------------------------
# runtime evaluator registry: spec name → (window view, target) →
# (bad_events, total_events). Registration validates against the
# inventory, mirroring memgov.Governor.register.

_EVALUATORS: dict = {}


def _evaluator(name: str):
    if name not in SLO_SPECS:
        raise ValueError(f"unknown SLO {name!r} — add it to "
                         f"slo.SLO_SPECS")

    def deco(fn):
        _EVALUATORS[name] = fn
        return fn
    return deco


@_evaluator("read_latency_p99_us")
def _eval_read_latency(view, target: float):
    return view.frac_above("query_latency_us{endpoint=\"query\"",
                           target)


@_evaluator("mutate_latency_p99_us")
def _eval_mutate_latency(view, target: float):
    return view.frac_above("query_latency_us{endpoint=\"mutate\"",
                           target)


@_evaluator("error_rate")
def _eval_error_rate(view, target: float):
    bad = view.delta("query_errors_total")
    total = view.hist_n("query_latency_us") + bad
    return bad, total


@_evaluator("shed_rate")
def _eval_shed_rate(view, target: float):
    return (view.delta("shed_total"),
            view.delta("admission_requests_total"))


@_evaluator("graphrag_read_p99")
def _eval_graphrag_latency(view, target: float):
    return view.frac_above("graphrag_latency_us", target)


def _budget_fraction(name: str, target: float) -> float:
    """The allowed bad fraction a burn of 1.0 consumes exactly: for
    latency SLOs the pN tail budget; for rate SLOs the target IS the
    budget."""
    if name.endswith("_us") or name.endswith("_p99"):
        return _LATENCY_BUDGET
    return max(target, 1e-9)


def _exemplar() -> str:
    """Best-effort trace id to pin on a breach: the newest slow-query
    ring entry (the request most likely to BE the regression), falling
    back to the newest finished cost record. Lazy imports — the server
    modules only load in a process that serves."""
    try:
        from dgraph_tpu_torch.server.http import slow_queries_snapshot
        entries = slow_queries_snapshot()
        if entries:  # ring appends newest last
            return entries[-1].get("trace_id", "") or ""
    except Exception:
        pass
    try:
        from dgraph_tpu_torch.utils import costprofile
        recs = costprofile.recent(1)
        if recs:
            return recs[0].get("trace_id", "") or ""
    except Exception:
        pass
    return ""


class SloEngine:
    """Evaluates every inventoried SLO against the time-series ring's
    fast and slow windows; owns the breach lifecycle (edge-triggered
    metrics + flight events, sustained-burn conviction feed)."""

    def __init__(self, targets: dict[str, float] | None = None,
                 fast_window_s: float = FAST_WINDOW_S,
                 slow_window_s: float = SLOW_WINDOW_S,
                 fast_burn: float = FAST_BURN,
                 slow_burn: float = SLOW_BURN,
                 sustain_evals: int = SUSTAIN_EVALS):
        self.targets = dict(DEFAULT_TARGETS)
        for k, v in (targets or {}).items():
            if k not in SLO_SPECS:
                raise ValueError(f"unknown SLO {k!r} — add it to "
                                 f"slo.SLO_SPECS")
            self.targets[k] = float(v)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_thresholds = {"fast": float(fast_burn),
                                "slow": float(slow_burn)}
        self.sustain_evals = int(sustain_evals)
        self._lock = locks.make_lock("slo.engine")
        self._states: dict[str, dict] = {}
        self._consec_fast: dict[str, int] = {}
        self._breached: dict[tuple[str, str], bool] = {}
        self.breaches_total = 0
        locks.guarded(self, "slo.engine")

    # -- evaluation -------------------------------------------------------

    def evaluate(self, ring, now: float | None = None) -> dict:
        """One evaluation pass over every SLO × both windows. `ring` is
        the timeseries.Ring; deterministic given its points (tests pass
        fabricated rings)."""
        views = {"fast": ring.window(self.fast_window_s, now=now),
                 "slow": ring.window(self.slow_window_s, now=now)}
        states: dict[str, dict] = {}
        events: list[tuple[str, str, dict]] = []
        with self._lock:
            for name in sorted(SLO_SPECS):
                target = self.targets[name]
                budget = _budget_fraction(name, target)
                st: dict = {"target": target, "budget": budget,
                            "windows": {}}
                fast_breached = False
                for win, view in views.items():
                    bad, total = _EVALUATORS[name](view, target)
                    frac = (bad / total) if total else 0.0
                    burn = frac / budget
                    threshold = self.burn_thresholds[win]
                    breached = total > 0 and burn >= threshold
                    st["windows"][win] = {
                        "bad": bad, "total": total,
                        "bad_frac": round(frac, 6),
                        "burn": round(burn, 4),
                        "threshold": threshold,
                        "breached": breached,
                        "span_s": round(view.span_s, 3)}
                    key = (name, win)
                    if breached and not self._breached.get(key):
                        events.append((name, win, st["windows"][win]))
                    self._breached[key] = breached
                    if win == "fast":
                        fast_breached = breached
                if fast_breached:
                    self._consec_fast[name] = (
                        self._consec_fast.get(name, 0) + 1)
                else:
                    self._consec_fast[name] = 0
                st["consec_fast"] = self._consec_fast[name]
                states[name] = st
            self._states = states
            self.breaches_total += len(events)
        for name, st in states.items():
            for win, w in st["windows"].items():
                METRICS.set_gauge("slo_burn_rate", w["burn"],
                                  slo=name, window=win)
        for name, win, w in events:
            self._on_breach(name, win, w)
        return states

    def _on_breach(self, name: str, win: str, w: dict) -> None:
        """Edge-triggered breach: count it and flight-record it with an
        exemplar trace id resolvable at /debug/traces?trace_id=."""
        METRICS.inc("slo_breaches_total", slo=name, window=win)
        trace_id = _exemplar()
        try:
            from dgraph_tpu_torch.utils import flightrec
            flightrec.emit("slo.breach", slo=name, window=win,
                           burn=w["burn"], bad=w["bad"],
                           total=w["total"], target=self.targets[name],
                           trace_id=trace_id)
        except Exception:
            pass

    # -- watchdog feed ----------------------------------------------------

    def convictable(self) -> list[dict]:
        """SLOs whose FAST burn has stayed breached for sustain_evals
        consecutive evaluations — what the flight-recorder watchdog
        convicts as kind=slo (utils/flightrec.py `_scan_slo`)."""
        out = []
        with self._lock:
            for name, n in self._consec_fast.items():
                if n >= self.sustain_evals:
                    st = self._states.get(name, {})
                    fast = st.get("windows", {}).get("fast", {})
                    out.append({"slo": name, "consec_fast": n,
                                "burn": fast.get("burn", 0.0),
                                "target": self.targets[name]})
        return out

    def status(self) -> dict:
        """The /debug/slo document."""
        with self._lock:
            return {"specs": {n: {"doc": SLO_SPECS[n],
                                  "target": self.targets[n]}
                              for n in sorted(SLO_SPECS)},
                    "windows": {"fast_s": self.fast_window_s,
                                "slow_s": self.slow_window_s},
                    "burn_thresholds": dict(self.burn_thresholds),
                    "states": self._states,
                    "breaches_total": self.breaches_total}


# the armed engine (None = disarmed): the watchdog's kind=slo scan and
# /debug/slo read this — one global load + None check when disarmed
ENGINE: SloEngine | None = None


def install(engine: SloEngine) -> SloEngine:
    global ENGINE
    ENGINE = engine
    return engine


def uninstall() -> None:
    global ENGINE
    ENGINE = None
