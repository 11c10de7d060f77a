"""Served DQL requests from client threads in a closed loop.

The mix is data (`traffic/<mix>.json`): templates with a `%(v)s` query
vector or a `%(m)s` message uid, in equal shares (each block of
len(templates) requests holds every template once, in an order drawn
from the seed). Request i's parameter is drawn from the seed and i, so
every seed sends the same shapes. Query vector components are N(0, 1)
draws rounded to multiples of 1/1024, so their text is exact. Each of
`clients` threads sends its next request when the last one answered
(`system.query`, `Alpha.query_raw`), until `seconds` have passed; the
window ends with the last answer. Latency runs from send to response
bytes. With a trace, `trace_seconds` in the middle of the window run
under the profiler, with the program's spans and k-NN counter read
around it.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark.reference import bounds

WARM, WINDOW, SAMPLE = 1, 2, 3      # request streams
ORDER, PARAM = 0, 1


def _rng(seed: int, *keys):
    return np.random.default_rng([int(seed) % (1 << 64), *keys])


class Requests:
    """Request i of a stream: (template, dql, query vector)."""

    def __init__(self, system, traffic: dict, seed: int, dim: int):
        self.system = system
        self.templates = traffic["templates"]
        self.seed = seed
        self.dim = dim
        self.scale = float(traffic["vector_scale"])

    def make(self, stream: int, i: int):
        t = len(self.templates)
        order = _rng(self.seed, stream, ORDER, i // t).permutation(t)
        tpl = self.templates[order[i % t]]
        r = _rng(self.seed, stream, PARAM, i)
        if tpl["param"] == "vector":
            ints = np.round(r.standard_normal(self.dim) * self.scale)
            vals = ints / self.scale
            q = vals.astype(np.float32)
            text = "[" + ", ".join(map(repr, vals.tolist())) + "]"
            dql = tpl["dql"] % {"v": text}
        else:
            m = int(self.system.messages[r.integers(
                0, len(self.system.messages))])
            q = self.system.query_vector(m)
            dql = tpl["dql"] % {"m": hex(m)}
        return tpl, dql, q


def _serve(system, reqs: Requests, stream: int, clients: int,
           seconds: float, first: int = 0):
    """Closed-loop clients over stream `stream` for `seconds`: (start,
    records {i: (template, t_send, t_answer, body or None)})."""
    lock = threading.Lock()
    nxt = [first]
    records: dict = {}
    errors: list = []
    t_start = time.perf_counter()
    t_end = t_start + seconds

    def client():
        while True:
            with lock:
                if time.perf_counter() >= t_end:
                    return
                i = nxt[0]
                nxt[0] += 1
            tpl, dql, _q = reqs.make(stream, i)
            t0 = time.perf_counter()
            try:
                body = system.query(dql)
            except Exception as e:   # noqa: BLE001 — a failed request
                body = None
                with lock:
                    errors.append(f"{tpl['name']}: {e!r}"[:300])
            records[i] = (tpl["name"], t0, time.perf_counter(), body)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for th in threads:
        th.start()
    return t_start, threads, records, errors


def run(system, traffic: dict, seconds: float, seed: int, tracer) -> dict:
    t_warm = time.perf_counter()
    reqs = Requests(system, traffic, seed, system.vecs.shape[1])
    tracer.host_events = False
    n_t = len(reqs.templates)
    for i in range(n_t * int(traffic["warm_per_template"])):
        tpl, dql, _q = reqs.make(WARM, i)
        system.query(dql)
    clients = int(traffic["clients"])
    _t, threads, _r, _e = _serve(system, reqs, WARM, clients,
                             float(traffic["warm_seconds"]),
                             first=n_t * int(traffic["warm_per_template"]))
    for th in threads:
        th.join()
    trace = {}
    before = _programs()
    system.phases["warm_s"] = time.perf_counter() - t_warm
    t_start, threads, records, errors = _serve(system, reqs, WINDOW,
                                               clients, seconds)
    if tracer.enabled:
        trace = _traced(tracer, t_start, seconds, traffic)
    for th in threads:
        th.join()
    after = _programs()
    diag = {k: after[k] - before[k] for k in after}
    per_s = np.bincount([int(r[2] - t_start) for r in records.values()])
    t_stop = max((r[2] for r in records.values()), default=t_start)
    window_s = t_stop - t_start
    lat = [r[2] - r[1] for r in records.values()]
    failed = sum(1 for r in records.values() if r[3] is None)
    done = len(records) - failed
    return {"t_start": t_start, "window_s": window_s,
            "attempted": len(records), "failed": failed,
            "e2e": {"requests_per_s": done / window_s,
                    "request_p95_ms": float(np.percentile(lat, 95)) * 1e3
                    if lat else float("nan")},
            "records": records, "reqs": reqs, "trace": trace,
            "diag": {"programs_in_window": diag, "errors": errors[:3],
                     "answers_per_second": per_s.tolist()}}


def _programs() -> dict:
    """The whole-block programs' counters (captures in the window mean
    a shape the warm-up missed)."""
    from dgraph_tpu_torch.engine import fused
    st = fused.status()
    return {k: st.get(k, 0) for k in ("captures", "hits", "misses",
                                      "evictions", "fallbacks")}


def _traced(tracer, t_start: float, seconds: float, traffic: dict) -> dict:
    """Profile `trace_seconds` from the middle of the window; collect
    the program's spans and k-NN scans meanwhile."""
    from dgraph_tpu_torch.utils import tracing
    from dgraph_tpu_torch.utils.metrics import METRICS

    span_s = float(traffic["trace_seconds"])
    time.sleep(max(0.0, t_start + (seconds - span_s) / 2
                   - time.perf_counter()))
    spans: dict = {}
    timeline: list = []

    def sink(s):
        spans.setdefault(s.name, []).append(s.dur_us / 1e6)
        timeline.append((s.name, s.start_us / 1e6,
                         (s.start_us + s.dur_us) / 1e6))

    def scans():
        return sum(METRICS.get("knn_route_total", route=r)
                   for r in ("device", "fused"))

    tracing.add_sink(sink)
    before = scans()
    try:
        with tracer.window():
            time.sleep(span_s)
    finally:
        tracing.remove_sink(sink)
    return {"program_spans": spans, "knn_scans": scans() - before,
            "timeline": timeline}


def sample(seed: int, bodies: dict, traffic: dict) -> list:
    """The answered requests checked: `check_requests` drawn from the
    seed, and the `check_longest` longest answers."""
    done = sorted(i for i, b in bodies.items() if b is not None)
    n = min(int(traffic["check_requests"]), len(done))
    pick = set(_rng(seed, SAMPLE).choice(done, n, replace=False).tolist()
               if n else [])
    longest = sorted(done, key=lambda i: -len(bodies[i]))
    pick.update(longest[:int(traffic["check_longest"])])
    return sorted(pick)


def judged(reqs: Requests, reference, picks: list, bodies: dict) -> dict:
    """The reference's reading of request `picks`' answers."""
    requests = []
    for i in picks:
        tpl, _dql, q = reqs.make(WINDOW, i)
        requests.append({"template": tpl["name"], "k": int(tpl["k"]),
                         "q": q})
    if not requests:
        return {"knn_gap": 0.0, "mean_err": 0.0, "mismatched": 0,
                "checked": 0}
    return reference.judge(requests, [bodies[i] for i in picks])


def check(system, reference, traffic: dict, out: dict, seed: int,
          ctx: dict) -> dict:
    """A sample of the answered requests, drawn from the seed, with the
    longest answers in it, judged by the plain reference."""
    bodies = {i: r[3] for i, r in out["records"].items()}
    got = judged(out["reqs"], reference, sample(seed, bodies, traffic),
                 bodies)
    ctx["checked"] = got["checked"]
    ctx.update(out["trace"])
    tablet = reference.vecs.shape
    ctx["knn_bound_s"] = bounds.knn_scan_bound(tablet[0],
                                               tablet[1])["bound_s"]
    lim = traffic["limits"]
    return {name: {"value": got[name], "limit": lim[name]}
            for name in ("knn_gap", "mean_err", "mismatched")}


def control(inputs, reference, traffic: dict, seed: int,
            count: int) -> dict:
    """The control's reading: window requests 0 .. count-1 answered by
    the reference in TF32 (`reference/rag.control_bodies`), sampled and
    judged as a run's answers are."""
    reqs = Requests(inputs, traffic, seed, inputs.vecs.shape[1])
    requests = []
    for i in range(count):
        tpl, _dql, q = reqs.make(WINDOW, i)
        requests.append({"template": tpl["name"], "k": int(tpl["k"]),
                         "q": q})
    bodies = dict(enumerate(reference.control(requests)))
    return judged(reqs, reference, sample(seed, bodies, traffic), bodies)
