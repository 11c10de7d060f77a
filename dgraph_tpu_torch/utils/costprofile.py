"""Query cost profiles: shape-keyed resource accounting.

Port of `dgraph_tpu/utils/costprofile.py` with plain `threading` locks
(ROADMAP Queue 1 item 9f). Per-request records join the plan features
that predict cost (query-shape fingerprint, lane count, padding, depth,
cache-hit bits, tablet sizes) with the measured costs (parse/plan/build,
per-kernel-family compile vs execute, bytes gathered, edges traversed,
outcome), under the reference's field vocabulary (`FIELDS`).

Collection is ambient, like utils/deadline.py: `Alpha._request` opens a
thread-local `Recorder` via `profile(lane)`; contributor sites (the batch
planner, the group launches, the engine's expansions, the whole-block
programs) call the module-level `note/add/add_shape/add_kernel/
note_launch`, which are one thread-local load and a None check when no
recorder is active. A kernel family's compile time is what the port
compiles: a CUDA-graph capture (`engine/fused.py`, family `fused`) and an
`nvcc` build (`utils/kbuild.py`, family `nvcc:<kernel>`).

Aggregation: finished records fold into `COSTS`, shape-keyed percentile
DIGESTS (power-of-two bucket histograms with integer state, so a merge is
exact and associative). At most `max_shapes` distinct shapes (default
MAX_LABEL_SETS); later novel shapes collapse into `other` and count
`cost_shapes_dropped_total`. Every finished record counts in
`cost_records_total{outcome=}`. The aggregate persists as JSON beside
the checkpoint (`costprofiles.json`) and merges across restarts; a
corrupt file counts in `sidecar_load_failures_total{file=}` and never
aborts a boot. Per-tablet cost sums (`add_tablet_cost`) feed a
clustered Alpha's health report to Zero (`Alpha.report_health`), which
tablet moves read; per-shard sums (`add_shard_cost`) wait for their
caller, the mesh route (item 10).

Surfaces: `summary()` (per-shape digests and the top-N shapes), a
`query.cost` span per request when tracing is on, `recent()` and the
sinks for a push pipeline (item 9f).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.metrics import MAX_LABEL_SETS, METRICS

__all__ = ["FIELDS", "DIGEST_FIELDS", "FEATURE_FIELDS", "Digest",
           "Recorder", "Aggregator", "COSTS", "profile", "active",
           "note", "note_max", "add", "add_shape", "add_kernel",
           "note_launch", "launch_frame",
           "add_tablet_cost", "tablet_costs", "add_shard_cost",
           "shard_costs", "recent",
           "add_sink", "remove_sink", "set_enabled", "summary",
           "save", "load", "reset"]

# -- the cost-record schema ---------------------------------------------------
# The reference's vocabulary, field for field.
# kind "cost" fields aggregate into per-shape percentile digests; kind
# "feature" fields aggregate as per-shape means (the cost model's
# regressors); kind "meta" fields identify/classify the record.
FIELDS: dict[str, dict] = {
    # meta
    "shape":             {"kind": "meta", "doc": "query-shape fingerprint (the digest key)"},
    "trace_id":          {"kind": "meta", "doc": "trace id — joins the record to its span tree"},
    "lane":              {"kind": "meta", "doc": "admission lane (read/mutate)"},
    "outcome":           {"kind": "meta", "doc": "ok | shed | deadline | cancelled | error"},
    "kernels":           {"kind": "meta", "doc": "per-kernel-family {compile_us, execute_us} breakdown"},
    # measured costs (digested per shape)
    "total_us":          {"kind": "cost", "doc": "whole-request wall µs inside Alpha._request"},
    "admission_wait_us": {"kind": "cost", "doc": "time queued before admission (admission.wait span)"},
    "plan_us":           {"kind": "cost", "doc": "parse + batch planning µs (batch.plan span)"},
    "build_us":          {"kind": "cost", "doc": "ELL/index build µs (batch.build_ell span)"},
    "compile_us":        {"kind": "cost", "doc": "compile µs across kernel families (CUDA-graph captures, nvcc builds)"},
    "execute_us":        {"kind": "cost", "doc": "kernel execute µs across families (batch.*_kernel)"},
    "bytes_gathered":    {"kind": "cost", "doc": "bytes moved by expansions/kernel gathers (model)"},
    "edges_traversed":   {"kind": "cost", "doc": "edges the request traversed (the north-star count)"},
    "rpc_legs":          {"kind": "cost", "doc": "outbound cluster RPC attempts"},
    "rpc_retries":       {"kind": "cost", "doc": "re-attempts the resilience layer spent"},
    "rpc_failovers":     {"kind": "cost", "doc": "read legs served by a non-preferred replica"},
    "predicted_us":      {"kind": "cost", "doc": "scheduler's pre-run cost prediction (utils/costprior.py; 0 = no prediction)"},
    # plan features (averaged per shape)
    "lanes":             {"kind": "feature", "doc": "kernel lanes launched (padded batch width)"},
    "padded_lanes":      {"kind": "feature", "doc": "zero-seeded padding lanes"},
    "padding_frac":      {"kind": "feature", "doc": "padded_lanes / lanes (scaled x1000)"},
    "depth":             {"kind": "feature", "doc": "kernel recursion depth (static compile axis)"},
    "bucket_mix":        {"kind": "feature", "doc": "segment-CSR degree-bucket blocks in the launched ELL"},
    "queries":           {"kind": "feature", "doc": "queries in the request (batch size)"},
    "tablet_rows":       {"kind": "feature", "doc": "rows of the largest tablet touched"},
    "plan_cache_hit":    {"kind": "feature", "doc": "1 = batch plan memo hit"},
    "ell_cache_hit":     {"kind": "feature", "doc": "1 = every ELL build was a snapshot-cache hit"},
    "jit_cache_hits":    {"kind": "feature", "doc": "compile-cache hits during the request (the reference's jit cache; 0 in the port)"},
    "mesh_shards":       {"kind": "feature", "doc": "mesh shards engaged by the request's expansions (0 = no mesh route)"},
    "kernel_launches":   {"kind": "feature", "doc": "separately dispatched device kernel launches (the count whole-query fusion collapses to 1)"},
    "launch_gap_us":     {"kind": "feature", "doc": "host-side µs between consecutive kernel launches — the dispatch overhead baseline for the fusion item"},
}

DIGEST_FIELDS = tuple(n for n, d in FIELDS.items() if d["kind"] == "cost")
FEATURE_FIELDS = tuple(n for n, d in FIELDS.items()
                       if d["kind"] == "feature")

_N_BUCKETS = 42          # power-of-two ladder: 1, 2, 4, … 2^40, +overflow
_RECENT_MAX = 512        # records retained for /debug/costs + push
UNCLASSIFIED = "unclassified"
OVERFLOW_SHAPE = "other"  # where novel shapes past the cap collapse


class Digest:
    """Bounded mergeable percentile digest over non-negative values.

    Power-of-two buckets with INTEGER state (counts, sum, min, max):
    merging is elementwise integer addition, hence exact and associative
    — the property that lets bench records, serving records, and
    restart-persisted records combine in any order (pinned by
    tests/test_costprofile.py). Bucket index is `int(v).bit_length()`,
    so adding costs no search; percentiles interpolate at the bucket
    midpoint and clamp into the exact [min, max] envelope."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * _N_BUCKETS
        self.count = 0
        self.sum = 0
        self.min = None
        self.max = 0

    def add(self, value) -> None:
        v = int(value)
        if v < 0:
            v = 0
        i = min(v.bit_length(), _N_BUCKETS - 1)
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.max = max(self.max, v)
        self.min = v if self.min is None else min(self.min, v)

    def merge(self, other: "Digest") -> "Digest":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.max = max(self.max, other.max)
        if other.min is not None:
            self.min = (other.min if self.min is None
                        else min(self.min, other.min))
        return self

    def percentile(self, p: float) -> int:
        """Approximate p-quantile (p in [0,1]): the midpoint of the
        bucket holding the p-th observation, clamped to [min, max]."""
        if not self.count:
            return 0
        rank = max(1, int(p * self.count + 0.999999))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                # bucket i holds [2^(i-1), 2^i); report its midpoint
                mid = ((1 << (i - 1)) + (1 << i)) // 2 if i else 0
                lo = self.min or 0
                return max(lo, min(mid, self.max))
        return self.max

    def to_dict(self) -> dict:
        return {"counts": list(self.counts), "count": self.count,
                "sum": self.sum, "min": self.min, "max": self.max}

    @classmethod
    def from_dict(cls, d: dict) -> "Digest":
        g = cls()
        src = list(d.get("counts", ()))[:_N_BUCKETS]
        for i, c in enumerate(src):
            g.counts[i] = int(c)
        g.count = int(d.get("count", 0))
        g.sum = int(d.get("sum", 0))
        g.min = d.get("min")
        if g.min is not None:
            g.min = int(g.min)
        g.max = int(d.get("max", 0))
        return g


class Recorder:
    """One request's accumulation buffer. Not thread-safe by design:
    it is thread-local for its request thread; cross-thread
    contributors (none today) would need their own record."""

    __slots__ = ("lane", "vals", "shapes", "kernels", "t0", "trace_id",
                 "_last_launch_end")

    def __init__(self, lane: str):
        self.lane = lane
        self.vals: dict[str, float] = {}
        self.shapes: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.t0 = time.perf_counter()
        self._last_launch_end: float | None = None
        from dgraph_tpu_torch.utils import tracing
        self.trace_id = tracing.current_trace_id()

    def note(self, field: str, value) -> None:
        self.vals[field] = value

    def add(self, field: str, delta) -> None:
        self.vals[field] = self.vals.get(field, 0) + delta

    def add_shape(self, component: str) -> None:
        if component not in self.shapes:
            self.shapes.append(component)

    def note_max(self, field: str, value) -> None:
        if value > self.vals.get(field, 0):
            self.vals[field] = value

    def shape_key(self) -> str:
        """The digest key this record will fold under — exposed so the
        scheduler (utils/costprior.py) can map query text → shape while
        the request is still open (finish() uses the same rule)."""
        return ("+".join(sorted(self.shapes))
                or self.lane or UNCLASSIFIED)

    def note_launch(self, start_t: float, end_t: float) -> None:
        """One device kernel launch spanning [start_t, end_t) on the
        host's perf_counter clock. Counts launches and accumulates the
        HOST-SIDE GAP since the previous launch ended — the per-request
        launch/dispatch overhead the whole-query-fusion item needed a
        measured baseline for (per-shape means surface at /debug/costs,
        and the fused path's acceptance number is this feature
        collapsing to 1). The last-launch timestamp is per-Recorder-
        FRAME (`launch_frame`): a nested sub-request leg (an upsert's
        query, a txn read inside a mutate) interleaving launches on the
        same thread must not bill its leg boundary — which includes
        parse/apply work, not dispatch overhead — as a launch gap."""
        self.add("kernel_launches", 1)
        last = self._last_launch_end
        if last is not None and start_t > last:
            self.add("launch_gap_us", int((start_t - last) * 1e6))
        self._last_launch_end = end_t

    @contextlib.contextmanager
    def launch_frame(self):
        """Scope one nested sub-request leg's launch-gap accounting:
        entering resets the gap baseline (the outer leg's last launch
        is not this leg's predecessor), leaving resets it again (this
        leg's last launch is not the outer leg's predecessor). Launch
        COUNTS still accumulate into the one shared record — only the
        gap attribution is frame-local."""
        self._last_launch_end = None
        try:
            yield
        finally:
            self._last_launch_end = None

    def add_kernel(self, family: str, compile_us: float = 0.0,
                   execute_us: float = 0.0) -> None:
        k = self.kernels.setdefault(family,
                                    {"compile_us": 0, "execute_us": 0})
        k["compile_us"] += int(compile_us)
        k["execute_us"] += int(execute_us)
        if compile_us:
            self.add("compile_us", int(compile_us))
        if execute_us:
            self.add("execute_us", int(execute_us))

    def finish(self, outcome: str) -> dict:
        # no shape component (mutations, schema queries): the lane is
        # the coarsest honest shape — never a silent "unclassified"
        # unless even the lane is unknown
        rec = {"shape": self.shape_key(),
               "trace_id": self.trace_id, "lane": self.lane,
               "outcome": outcome,
               "total_us": int((time.perf_counter() - self.t0) * 1e6),
               "kernels": self.kernels}
        for f in DIGEST_FIELDS:
            if f != "total_us":
                rec[f] = int(self.vals.get(f, 0))
        for f in FEATURE_FIELDS:
            rec[f] = int(self.vals.get(f, 0))
        return rec


class _ShapeStats:
    __slots__ = ("count", "digests", "features")

    def __init__(self):
        self.count = 0
        self.digests = {f: Digest() for f in DIGEST_FIELDS}
        self.features = dict.fromkeys(FEATURE_FIELDS, 0)

    def record(self, rec: dict) -> None:
        self.count += 1
        for f in DIGEST_FIELDS:
            self.digests[f].add(rec.get(f, 0))
        for f in FEATURE_FIELDS:
            self.features[f] += int(rec.get(f, 0))


class Aggregator:
    """Shape-keyed digest store: bounded cardinality, exact merge,
    JSON persistence. The module-level `COSTS` instance is the
    process-wide registry (METRICS-style); tests construct their own."""

    def __init__(self, max_shapes: int = MAX_LABEL_SETS):
        self._lock = threading.Lock()
        self._shapes: dict[str, _ShapeStats] = {}
        self.max_shapes = int(max_shapes)
        self.records_total = 0

    def _guard(self, shape: str) -> str:
        """Admit or collapse a shape key (caller holds the lock) — the
        metrics label-limit discipline applied to shapes: known keys
        keep recording exactly, novel keys past the cap collapse into
        `other` and count the clamp."""
        if shape in self._shapes or shape == OVERFLOW_SHAPE:
            return shape
        if len(self._shapes) >= self.max_shapes:
            METRICS.inc("cost_shapes_dropped_total")
            return OVERFLOW_SHAPE
        return shape

    def record(self, rec: dict) -> None:
        with self._lock:
            shape = self._guard(rec.get("shape", UNCLASSIFIED))
            st = self._shapes.get(shape)
            if st is None:
                st = self._shapes[shape] = _ShapeStats()
            st.record(rec)
            self.records_total += 1

    def merge(self, other: "Aggregator") -> "Aggregator":
        with other._lock:
            shapes = {s: st for s, st in other._shapes.items()}
            n = other.records_total
        with self._lock:
            for shape, st in shapes.items():
                shape = self._guard(shape)
                mine = self._shapes.get(shape)
                if mine is None:
                    mine = self._shapes[shape] = _ShapeStats()
                mine.count += st.count
                for f in DIGEST_FIELDS:
                    mine.digests[f].merge(st.digests[f])
                for f in FEATURE_FIELDS:
                    mine.features[f] += st.features[f]
            self.records_total += n
        return self

    def to_doc(self, top_n: int = 10) -> dict:
        """The /debug/costs document: per-shape percentiles + feature
        means, and the top-N most expensive shapes by total µs spent."""
        with self._lock:
            shapes = {}
            for shape, st in self._shapes.items():
                shapes[shape] = {
                    "count": st.count,
                    "features": {f: round(st.features[f]
                                          / max(st.count, 1), 2)
                                 for f in FEATURE_FIELDS
                                 if st.features[f]},
                    "costs": {
                        f: {"p50": d.percentile(0.50),
                            "p90": d.percentile(0.90),
                            "p99": d.percentile(0.99),
                            "max": d.max, "sum": d.sum}
                        for f, d in st.digests.items() if d.sum},
                }
            top = sorted(
                self._shapes,
                key=lambda s: self._shapes[s].digests["total_us"].sum,
                reverse=True)[:top_n]
            return {"records_total": self.records_total,
                    "shapes": shapes,
                    "top": [{"shape": s,
                             "total_us_sum":
                                 self._shapes[s].digests["total_us"].sum,
                             "count": self._shapes[s].count}
                            for s in top]}

    # -- persistence (next to the checkpoint dir) -----------------------------
    def to_state(self) -> dict:
        with self._lock:
            return {"version": 1, "records_total": self.records_total,
                    "shapes": {
                        s: {"count": st.count,
                            "features": dict(st.features),
                            "digests": {f: d.to_dict()
                                        for f, d in st.digests.items()}}
                        for s, st in self._shapes.items()}}

    @classmethod
    def from_state(cls, state: dict,
                   max_shapes: int = MAX_LABEL_SETS) -> "Aggregator":
        agg = cls(max_shapes=max_shapes)
        agg.records_total = int(state.get("records_total", 0))
        for shape, sd in state.get("shapes", {}).items():
            st = _ShapeStats()
            st.count = int(sd.get("count", 0))
            for f, dd in sd.get("digests", {}).items():
                if f in st.digests:
                    st.digests[f] = Digest.from_dict(dd)
            for f, v in sd.get("features", {}).items():
                if f in st.features:
                    st.features[f] = int(v)
            agg._shapes[shape] = st
        return agg

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_state(), f)

    def load(self, path: str) -> bool:
        """Merge a persisted aggregate into this one (restart path).
        A missing file is a silent no-op; a corrupt/truncated or
        wrong-shaped one (a kill mid-write, a bad disk) is COUNTED and
        logged but still never aborts the boot — cost history is
        telemetry, the store starts fresh."""
        try:
            with open(path) as f:
                state = json.load(f)
            self.merge(Aggregator.from_state(state))
        except OSError:
            return False
        except Exception:  # noqa: BLE001 — corrupt sidecar: start fresh
            import os

            from dgraph_tpu_torch.utils import logging as xlog
            METRICS.inc("sidecar_load_failures_total",
                        file=os.path.basename(path))
            xlog.get("costprofile").warning(
                "corrupt cost-profile sidecar %s ignored; starting "
                "with an empty aggregate", path, exc_info=True)
            return False
        return True

    def clear(self) -> None:
        with self._lock:
            self._shapes.clear()
            self.records_total = 0


# -- module-level ambient recorder (METRICS-style process singletons) --------

COSTS = Aggregator()
# per-tablet (predicate) cost sums in µs-equivalents: measured kernel
# execute + ELL build µs where available, a modeled µs for host
# expansions. Bounded metrics-style (cap + "other"); ships to Zero in
# the health heartbeat so tablet moves prefer under-loaded groups.
_TABLET_COSTS: dict[str, int] = {}
# per-device-shard cost sums (same µs-equivalent scale, bounded the same
# way): the residency and balance signal of a sharded serving path
_SHARD_COSTS: dict[str, int] = {}
_TABLET_LOCK = threading.Lock()
_RECENT: list = []            # ring of finished records (lock-guarded)
_RECENT_LOCK = threading.Lock()
_SINKS: list = []             # push-pipeline subscribers
_TLS = threading.local()
_ENABLED = True


def set_enabled(flag: bool) -> None:
    """Disarm recording (the switch the <5% overhead guard flips);
    aggregates already collected keep serving."""
    global _ENABLED
    _ENABLED = bool(flag)


def active() -> Recorder | None:
    return getattr(_TLS, "rec", None)


def _classify(e: BaseException) -> str:
    if isinstance(e, dl.DeadlineExceeded):
        return "deadline"
    if isinstance(e, dl.Cancelled):
        return "cancelled"
    # by name: admission (server/admission.py) lives above utils
    if type(e).__name__ == "ServerOverloaded":
        return "shed"
    return "error"


@contextlib.contextmanager
def profile(lane: str):
    """Open the request's ambient Recorder (Alpha._request's shell).
    Nested server calls ride the outer recorder, mirroring the outer
    budget/token they already ride; classification mirrors the
    lifecycle contract: shed/deadline/cancelled/error vs ok."""
    if not _ENABLED or getattr(_TLS, "rec", None) is not None:
        yield None
        return
    rec = Recorder(lane)
    _TLS.rec = rec
    outcome = "ok"
    try:
        yield rec
    except BaseException as e:
        outcome = _classify(e)
        raise
    finally:
        _TLS.rec = None
        _finish(rec, outcome)


def _finish(rec: Recorder, outcome: str) -> None:
    from dgraph_tpu_torch.utils import tracing
    record = rec.finish(outcome)
    COSTS.record(record)
    with _RECENT_LOCK:
        _RECENT.append(record)
        if len(_RECENT) > _RECENT_MAX:
            del _RECENT[: len(_RECENT) - _RECENT_MAX]
    METRICS.inc("cost_records_total", outcome=outcome)
    if tracing.enabled():
        # the record's span form: a zero-width child of the request's
        # trace, so /debug/traces?trace_id= shows the joined costs
        with tracing.span("query.cost", shape=record["shape"],
                          outcome=outcome,
                          total_us=record["total_us"],
                          edges=record["edges_traversed"],
                          rpc_legs=record["rpc_legs"]):
            pass
    if _SINKS:
        for sink in tuple(_SINKS):
            try:
                sink(record)
            except Exception:  # noqa: BLE001 — a sink must never fail a request
                pass


# cheap contributor entry points: one TLS load + None check when idle
def note(field: str, value) -> None:
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.note(field, value)


def add(field: str, delta) -> None:
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.add(field, delta)


def add_shape(component: str) -> None:
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.add_shape(component)


def note_max(field: str, value) -> None:
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.note_max(field, value)


def add_kernel(family: str, compile_us: float = 0.0,
               execute_us: float = 0.0) -> None:
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.add_kernel(family, compile_us=compile_us,
                       execute_us=execute_us)


def note_launch(start_t: float, end_t: float) -> None:
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.note_launch(start_t, end_t)


@contextlib.contextmanager
def launch_frame():
    """Module-level form of `Recorder.launch_frame` for contributor
    sites that don't hold the recorder (`Alpha._request`'s nested
    branch, the upsert query leg): a no-op when no request is being
    profiled."""
    rec = getattr(_TLS, "rec", None)
    if rec is None:
        yield
        return
    with rec.launch_frame():
        yield


def add_tablet_cost(pred: str, us) -> None:
    """Charge `us` µs-equivalents of work to a predicate's tablet (the
    placement signal — see _TABLET_COSTS). Cheap: one lock + dict add
    per kernel launch / level expansion, gated on the same switch the
    <5% overhead guard flips."""
    if not _ENABLED:
        return
    with _TABLET_LOCK:
        if pred not in _TABLET_COSTS \
                and len(_TABLET_COSTS) >= MAX_LABEL_SETS:
            pred = OVERFLOW_SHAPE
        _TABLET_COSTS[pred] = _TABLET_COSTS.get(pred, 0) + int(us)


def tablet_costs() -> dict[str, int]:
    """Per-tablet cost sums since process start (heartbeat payload)."""
    with _TABLET_LOCK:
        return dict(_TABLET_COSTS)


def add_shard_cost(shard, us) -> None:
    """Charge `us` µs-equivalents of work to one device shard, the
    shard-keyed twin of `add_tablet_cost`: tablet sums drive Zero's
    group placement, shard sums the balance of a sharded route (the
    mesh, ROADMAP Queue 1 item 10, is its caller)."""
    if not _ENABLED:
        return
    key = str(shard)
    with _TABLET_LOCK:
        if key not in _SHARD_COSTS \
                and len(_SHARD_COSTS) >= MAX_LABEL_SETS:
            key = OVERFLOW_SHAPE
        _SHARD_COSTS[key] = _SHARD_COSTS.get(key, 0) + int(us)


def shard_costs() -> dict[str, int]:
    """Per-shard cost sums since process start."""
    with _TABLET_LOCK:
        return dict(_SHARD_COSTS)


def recent(n: int = 100) -> list[dict]:
    with _RECENT_LOCK:
        return _RECENT[-n:]


def add_sink(fn) -> None:
    """Subscribe to finished records (the live push pipeline). Sinks
    must be non-blocking: they run on the request thread."""
    if fn not in _SINKS:
        _SINKS.append(fn)


def remove_sink(fn) -> None:
    with contextlib.suppress(ValueError):
        _SINKS.remove(fn)


def summary(top_n: int = 10) -> dict:
    """The BENCH-JSON / debug summary of the process aggregate."""
    return COSTS.to_doc(top_n=top_n)


def save(path: str) -> None:
    COSTS.save(path)


def load(path: str) -> bool:
    return COSTS.load(path)


def reset() -> None:
    """Test hook: forget aggregates, recent ring, and sinks."""
    COSTS.clear()
    with _RECENT_LOCK:
        _RECENT.clear()
    with _TABLET_LOCK:
        _TABLET_COSTS.clear()
        _SHARD_COSTS.clear()
    del _SINKS[:]
