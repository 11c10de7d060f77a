"""Prometheus-text metrics registry with labels.

Port of `dgraph_tpu/utils/metrics.py`, the same registry under its
`metrics.registry` lock. Reference parity: `x/metrics.go` + the
`/debug/prometheus_metrics` endpoint — query latency histograms, pending txns, and (our north-star
first-class counter, per BASELINE.json) edges traversed. No client
library dependency: counters/gauges/histograms rendered in Prometheus
text exposition format directly, including label sets with the escaping
rules the format mandates (`\\`, `\"`, `\n` in label values).

Every series is keyed (name, sorted label tuple); label-free calls keep
their historical plain-name identity so existing consumers (snapshot
readers, the cluster transfer-byte tests) see no change. Histograms use
the standard µs latency bucket ladder (`BUCKETS_US`) unless the first
observation for a name registers a custom ladder.

Cardinality guard: a label value sourced from data (predicate names,
peer addrs) can explode a metric into unbounded series — the classic
Prometheus cardinality bomb. Each metric NAME admits at most
`max_label_sets` distinct label-value sets (default MAX_LABEL_SETS;
`set_label_limit` overrides per name); later novel sets collapse into
one overflow series labeled `other="true"`, and every collapsed
recording counts in `metrics_series_dropped_total` so the clamp itself
is visible. Known sets keep recording exactly — only NEW identities
overflow.
"""

from __future__ import annotations

from dgraph_tpu_torch.utils import locks

# standard µs latency ladder: 100µs … 10s, then +Inf
BUCKETS_US = (100, 1_000, 10_000, 100_000, 1_000_000, 10_000_000)
_BUCKETS = BUCKETS_US  # back-compat alias

MAX_LABEL_SETS = 64              # default per-name label-set cap
OVERFLOW_KEY = (("other", "true"),)  # where novel sets collapse
DROPPED_SERIES = "metrics_series_dropped_total"


def _label_key(labels: dict) -> tuple:
    # values stringify at the key: one series per rendered identity, and
    # render()'s sorted() never compares int with str across series
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _series(name: str, lk: tuple, extra: str = "") -> str:
    """`name` or `name{a="b",...}`; `extra` appends e.g. the le label."""
    parts = [f'{k}="{_escape(v)}"' for k, v in lk]
    if extra:
        parts.append(extra)
    return f"{name}{{{','.join(parts)}}}" if parts else name


class Registry:
    def __init__(self):
        self._lock = locks.make_lock("metrics.registry")
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], list] = {}
        self._hist_buckets: dict[str, tuple] = {}
        self._label_sets: dict[str, set] = {}   # name → admitted label sets
        self._label_limits: dict[str, int] = {}  # per-name cap overrides
        self.max_label_sets = MAX_LABEL_SETS
        self._enabled = True
        locks.guarded(self, "metrics.registry")

    def set_enabled(self, flag: bool) -> None:
        """Disarm recording (render/snapshot still serve what exists) —
        the switch the <5% query-path overhead guard flips."""
        self._enabled = bool(flag)

    def set_label_limit(self, name: str, n: int) -> None:
        """Per-name override of the label-set cardinality cap."""
        with self._lock:
            self._label_limits[name] = int(n)

    def _guard(self, name: str, lk: tuple) -> tuple:
        """Admit or collapse a label set (caller holds the lock).
        Label-free series and already-admitted sets pass through; a
        novel set past the cap collapses to `other="true"` and counts
        a dropped recording."""
        if not lk or lk == OVERFLOW_KEY:
            return lk
        seen = self._label_sets.setdefault(name, set())
        if lk in seen:
            return lk
        cap = self._label_limits.get(name, self.max_label_sets)
        if len(seen) >= cap:
            dk = (DROPPED_SERIES, ())
            self._counters[dk] = self._counters.get(dk, 0.0) + 1.0
            return OVERFLOW_KEY
        seen.add(lk)
        return lk

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if not self._enabled:
            return
        lk = _label_key(labels)
        with self._lock:
            k = (name, self._guard(name, lk))
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self._enabled:
            return
        lk = _label_key(labels)
        with self._lock:
            self._gauges[(name, self._guard(name, lk))] = value

    def observe(self, name: str, value: float,
                buckets: tuple | None = None, **labels) -> None:
        """Histogram observation. Buckets default to the µs ladder; a
        custom ladder binds to `name` on first observation (per-name, so
        every label set of one histogram shares one ladder)."""
        if not self._enabled:
            return
        with self._lock:
            k = (name, self._guard(name, _label_key(labels)))
            bks = self._hist_buckets.setdefault(
                name, tuple(buckets) if buckets else BUCKETS_US)
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = [[0] * (len(bks) + 1), 0.0, 0]
            counts, _sum, _n = h
            for i, b in enumerate(bks):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            h[1] += value
            h[2] += 1

    def get(self, name: str, **labels) -> float:
        """Current counter value (0.0 when the series doesn't exist)."""
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0.0)

    def render(self) -> str:
        """Prometheus text exposition format."""
        out = []
        with self._lock:
            for kind, table in (("counter", self._counters),
                                ("gauge", self._gauges)):
                last_name = None
                for (name, lk), v in sorted(table.items()):
                    if name != last_name:
                        out.append(f"# TYPE dgraph_tpu_{name} {kind}")
                        last_name = name
                    out.append(f"dgraph_tpu_{_series(name, lk)} {v}")
            last_name = None
            for (name, lk), (counts, s, n) in sorted(self._hists.items()):
                if name != last_name:
                    out.append(f"# TYPE dgraph_tpu_{name} histogram")
                    last_name = name
                bks = self._hist_buckets[name]
                acc = 0
                for b, c in zip(bks, counts):
                    acc += c
                    le = f'le="{b}"'
                    out.append(
                        f"dgraph_tpu_{_series(name + '_bucket', lk, le)}"
                        f" {acc}")
                inf = 'le="+Inf"'
                out.append(
                    f"dgraph_tpu_{_series(name + '_bucket', lk, inf)} {n}")
                out.append(f"dgraph_tpu_{_series(name + '_sum', lk)} {s}")
                out.append(f"dgraph_tpu_{_series(name + '_count', lk)} {n}")
        return "\n".join(out) + "\n"

    def names(self) -> set:
        """Every metric name recorded so far: counters, gauges and
        histograms."""
        with self._lock:
            return {n for table in (self._counters, self._gauges,
                                    self._hists) for n, _lk in table}

    def snapshot(self) -> dict:
        """Flat dict view. Label-free series keep their bare name (the
        historical shape); labeled ones render as `name{k="v",...}`."""
        with self._lock:
            return {
                "counters": {_series(n, lk): v
                             for (n, lk), v in self._counters.items()},
                "gauges": {_series(n, lk): v
                           for (n, lk), v in self._gauges.items()},
            }

    def hist_snapshot(self) -> dict:
        """Histogram series view for the time-series sampler: rendered
        series name → {"buckets": ladder, "counts": cumulative-free
        per-bucket counts (last slot = +Inf), "sum": Σvalues, "n": N}.
        Copies under the lock so the sampler diffs stable points."""
        with self._lock:
            return {
                _series(n, lk): {"buckets": self._hist_buckets[n],
                                 "counts": list(counts),
                                 "sum": s, "n": n_obs}
                for (n, lk), (counts, s, n_obs) in self._hists.items()
            }


METRICS = Registry()
