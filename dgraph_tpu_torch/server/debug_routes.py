"""Debug-endpoint inventory: every `/debug/*` route the port serves.

Port of `dgraph_tpu/server/debug_routes.py`, with only the rows whose
handlers exist here. `server/http.py` renders `GET /debug` from this
dict and keys its dispatch tables (`_DEBUG_GET` / `_DEBUG_POST`) on the
same paths; `tests/test_torch_http.py` pins the two to each other in
both directions. The reference's `/debug/fleet/flight`, `/debug/locks`,
`/debug/races`, `/debug/flightrecorder`, `/debug/timeseries` and
`/debug/slo` come with ROADMAP Queue 1 item 9f.

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
    "/debug/peers":
        "GET: per-peer circuit-breaker state, EMA latency, last error "
        "+ zero health",
    "/debug/fleet":
        "GET: cluster-wide snapshot — per-node fragments fanned out "
        "over the worker transport, exactly-merged cost digests, "
        "instance-labeled metrics; degrades per dark peer, never 500s",
    "/debug/memory":
        "GET: memory-governor snapshot — per-cache resident bytes / "
        "registrants / evictions against the device+host budgets and "
        "watermarks, allocation-failure counters, degraded shapes",
}
