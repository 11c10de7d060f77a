"""Debug-endpoint inventory: every `/debug/*` route the port serves.

Port of `dgraph_tpu/server/debug_routes.py`: the reference's rows, in
its order. `server/http.py` renders `GET /debug` from this dict and
keys its dispatch tables (`_DEBUG_GET` / `_DEBUG_POST`) on the same
paths; `tests/test_torch_http.py` pins the two to each other in both
directions.

Import-free, so a tool can read the inventory without the server.
"""

from __future__ import annotations

DEBUG_ENDPOINTS: dict[str, str] = {
    "/debug":
        "GET: this index — every debug endpoint with a one-liner",
    "/debug/prometheus_metrics":
        "GET: every metric series in Prometheus text exposition format",
    "/debug/traces":
        "GET: span JSON; ?trace_id= one request's spans, ?peer= proxies "
        "a cluster peer's registry, ?n= limits the recent ring",
    "/debug/events":
        "GET: the same spans as Chrome trace-event JSON — load the "
        "body in Perfetto / chrome://tracing",
    "/debug/costs":
        "GET: shape-keyed cost digests + feature means + top-N "
        "expensive shapes + the whole-block program cache (hits, "
        "misses, captures); ?recent=true adds the raw record ring",
    "/debug/slow_queries":
        "GET: structured slow-query ring; ?trace_id= filters to one "
        "request (its span tree is one hop away at /debug/traces)",
    "/debug/profile":
        "GET: device-capture status; POST {action: start|stop} runs a "
        "single-flight torch.profiler capture (409 on conflict)",
    "/debug/scheduler":
        "GET: cost priors with hit/fallback counts, predicted-vs-"
        "actual error, lane EMAs, feature fit, admission work ahead, "
        "fused-vs-staged route counts + program cache",
    "/debug/admission":
        "GET: per-lane inflight/queued/shed counts + limits",
    "/debug/locks":
        "GET: lock-order sanitizer graph, detected cycles (both "
        "stacks), long holds",
    "/debug/races":
        "GET: Eraser lockset race sanitizer reports, each with both "
        "access stacks",
    "/debug/peers":
        "GET: per-peer circuit-breaker state, EMA latency, last error "
        "+ zero health",
    "/debug/flightrecorder":
        "GET: flight ring + watchdog state + recent dumps; POST "
        "{action: dump} writes and returns a one-shot diagnostic "
        "bundle (stacks, ring, every debug surface, metrics, config)",
    "/debug/fleet":
        "GET: cluster-wide snapshot — per-node fragments fanned out "
        "over the worker transport, exactly-merged cost digests, "
        "instance-labeled metrics; degrades per dark peer, never 500s",
    "/debug/fleet/flight":
        "GET: flight-recorder snapshot (in-flight ops with stacks, "
        "ring, watchdog); ?peer=host:port pulls a cluster peer's over "
        "the DebugFlight RPC, ?n= limits the ring tail",
    "/debug/memory":
        "GET: memory-governor snapshot — per-cache resident bytes / "
        "registrants / evictions against the device+host budgets and "
        "watermarks, allocation-failure counters, degraded shapes",
    "/debug/timeseries":
        "GET: retained metrics history — the sampler ring's windowed "
        "points (counters as rates, histograms as p50/p90/p99); "
        "?name= filters series by prefix, ?window= bounds the "
        "lookback seconds, ?rate=false serves raw deltas",
    "/debug/slo":
        "GET: SLO engine state — per-objective targets, fast/slow "
        "window burn rates, breach counts, and the sustained-burn "
        "conviction feed the watchdog convicts as kind=slo",
}
