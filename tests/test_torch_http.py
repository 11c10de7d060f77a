"""The port's HTTP front end against the reference's.

The reference's own HTTP cases (`test_server.py`'s single-node cases,
the HTTP forms of `test_upsert.py`, `test_maintenance.py`'s admin
triggers, `test_mvcc_retention.py`'s `/commit`, `test_costprofile.py`'s
`/debug/costs`) run with the port's objects bound in (the harness of
`test_torch_lifecycle.py`: `make_http_server`, `Alpha` on the CPU), then
with the reference's. Each run's transcript holds every `Alpha` call's
result and every HTTP answer the case read (`record_http`): the path,
the status and the body. The two must be equal, exactly, but for the
fields that carry a clock or an id: trace and span ids, `uptime`, the
server's ephemeral `addr`,
latency and µs fields, `Retry-After` values (each checked to be at
least 1 s on the port, RFC 9110's whole seconds) and a login token
(recorded as the user it verifies to; it carries its expiry). The
`/debug/*` documents are the process's own state (metrics, spans,
caches), different between two packages in one process by
construction: their status codes are compared, and the cases' own
assertions read their contents. A case whose threads decide the order
of its transcript compares the sorted transcripts.

The port's own checks: the debug inventory and the route tables agree
both ways; `/debug/memory` is `GOVERNOR.status()`; a `/debug/profile`
round trip writes a Chrome trace (the reference's case reads
`jax.profiler`'s `.trace.json.gz`); `/admin/backup/verify` answers as
`verify_chain` (the reference's whole case, its CLI half too, runs in
`test_torch_cli.py`); and
8 concurrent HTTP clients get the answers one client gets.
"""

import base64
import io
import json
import re
import threading
import urllib.error
import urllib.request

import pytest

import test_backup
import test_costprofile
import test_maintenance
import test_mvcc_retention
import test_server
import test_upsert
from dgraph_tpu_torch.server import http as port_http
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.server.debug_routes import DEBUG_ENDPOINTS
from dgraph_tpu_torch.utils import memgov
from test_torch_lifecycle import (PORT, REF, Transcript, bound,
                                 run_reference_case)
from test_torch_lifecycle import settled_threads  # noqa: F401 (autouse)
from test_torch_memgov import reset_cost_state

# -- recording HTTP answers -----------------------------------------------------

_VOLATILE = {"trace_id", "span_id", "parent_id", "uptime", "addr",
             "server_latency", "retry_after_s", "age_s"}
_TIME_IN_TEXT = re.compile(r"\d+(?:\.\d+)?\s?m?s\b")


def _norm(v):
    """A JSON answer with its clocks and ids written as placeholders."""
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            if k in _VOLATILE or k.endswith(("_us", "_ms")):
                out[k] = f"<{k}>"
            elif k == "accessJWT":
                doc = json.loads(base64.urlsafe_b64decode(x.split(".")[0]))
                out[k] = f"<token for {doc['u']}>"
            else:
                out[k] = _norm(x)
        return out
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, str):
        return _TIME_IN_TEXT.sub("<t>", v)
    return v


def _entry(pkg, req, status, headers, body: bytes) -> dict:
    url = req.full_url if isinstance(req, urllib.request.Request) else req
    path = urllib.request.urlparse(url)
    query = re.sub(r"trace_id=\w+", "trace_id=<id>", path.query)
    path = path.path + (f"?{query}" if query else "")
    e = {"path": path, "status": status}
    retry = headers.get("Retry-After") if headers is not None else None
    if retry is not None:
        if pkg == PORT:
            assert int(retry) >= 1, retry     # RFC 9110 delay-seconds
        e["retry_after"] = "<retry-after>"
    if path.startswith("/debug") and not path.startswith(
            ("/debug/profile", "/debug/admission")):
        return e
    try:
        e["body"] = _norm(json.loads(body))
    except ValueError:
        e["body"] = body.decode(errors="replace")
    return e


class _Answer(io.BytesIO):
    """An urlopen response whose body was already read (and recorded)."""

    def __init__(self, body, status, headers, url):
        super().__init__(body)
        self.status = self.code = status
        self.headers = headers
        self.url = url

    def getcode(self):
        return self.status

    def info(self):
        return self.headers


def record_http(m, pkg, log):
    """Route `urllib.request.urlopen` through a recorder for one run."""
    real = urllib.request.urlopen

    def urlopen(req, *a, **kw):
        try:
            r = real(req, *a, **kw)
        except urllib.error.HTTPError as e:
            body = e.read()
            log.append(_entry(pkg, req, e.code, e.headers, body))
            raise urllib.error.HTTPError(e.url, e.code, e.msg, e.headers,
                                         io.BytesIO(body)) from None
        with r:
            body = r.read()
        log.append(_entry(pkg, req, r.status, r.headers, body))
        return _Answer(body, r.status, r.headers, r.url)

    m.setattr(urllib.request, "urlopen", urlopen)


def compare_http_case(module, name, tmp_path, monkeypatch, unordered=False,
                      cache=None, factory=None, fixtures=None, between=None):
    """Both runs of one case with HTTP answers recorded; the transcripts
    must be equal (sorted first when threads order them)."""
    out = {}
    for pkg in (PORT, REF):
        log = []
        with monkeypatch.context() as m:
            record_http(m, pkg, log)
            out[pkg] = run_reference_case(
                module, name, pkg, tmp_path / pkg, monkeypatch,
                factory=factory, cache=cache, fixtures=fixtures,
                after=lambda tr: [tr.add("http", e) for e in log])
        if between is not None:
            between()
    port, ref = out[PORT], out[REF]
    if unordered:
        port, ref = sorted(port), sorted(ref)
    assert port == ref
    return out[PORT]


# -- the reference's cases ----------------------------------------------------------

SERVER_CASES = ["test_http_endpoints", "test_trace_id_echo_and_debug_surface",
                "test_slow_query_log_counts_and_logs",
                "test_http_error_paths",
                "test_client_disconnect_cancels_request_and_frees_token"]
# the disconnect watcher cancels at whatever checkpoint the request
# reached: the stub records nothing, so only the order may differ
UNORDERED = {"test_client_disconnect_cancels_request_and_frees_token"}
OTHER_CASES = [(test_upsert, "test_http_upsert_paths"),
               (test_upsert, "TestJsonUpsert::test_http_json_list"),
               (test_maintenance, "test_admin_http_triggers"),
               (test_mvcc_retention, "test_http_commit_endpoint"),
               (test_costprofile,
                "test_debug_costs_serves_shape_digests_for_batch_workload")]
CASES = [(test_server, n) for n in SERVER_CASES] + OTHER_CASES
_SEEDS: dict = {}     # (package, module, fixture) -> the seed checkpoint


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_reference_http_case_on_port(module, name, tmp_path, monkeypatch,
                                     tmp_path_factory, caplog):
    # each run starts from empty cost profiles: /debug/costs ranks the
    # shapes the process has seen, other tests' among them
    def fresh():
        caplog.clear()
        reset_cost_state()

    fresh()
    try:
        compare_http_case(module, name, tmp_path, monkeypatch,
                          unordered=name in UNORDERED, cache=_SEEDS,
                          factory=tmp_path_factory,
                          fixtures={"caplog": caplog}, between=fresh)
    finally:
        reset_cost_state()


def test_case_list_covers_the_front_end():
    """Every single-node HTTP case of test_server.py is here; the rest of
    the module is gRPC serving (test_torch_cluster.py) and mesh serving
    (test_torch_mesh.py)."""
    single = {n for n in dir(test_server) if n.startswith("test_")
              and "grpc" not in n and "mesh" not in n}
    assert single == set(SERVER_CASES)


# -- the port's own checks --------------------------------------------------------

def _alpha():
    a = Alpha(device="cpu", device_threshold=10**9)
    a.alter("name: string @index(exact) .\nfriend: [uid] @reverse .")
    a.mutate(set_nquads="\n".join(
        f'_:p{i} <name> "p{i}" .\n_:p{i} <friend> _:p{(i * 7 + 3) % 40} .'
        for i in range(40)))
    return a


@pytest.fixture()
def served():
    a = _alpha()
    srv = port_http.make_http_server(a)
    port_http.serve_background(srv)
    yield a, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def _post(url, body: bytes, ctype="application/dql"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_debug_inventory_and_route_tables_agree_both_ways():
    """Every inventoried path has a handler, every handler a row; the
    cluster's rows (item 9e) and the flight recorder's, time series',
    SLO and sanitizer rows (item 9f, first half) are served."""
    served_paths = set(port_http._DEBUG_GET) | set(port_http._DEBUG_POST)
    assert served_paths == set(DEBUG_ENDPOINTS)
    srv = port_http.make_http_server(_alpha())
    try:
        for name in (*port_http._DEBUG_GET.values(),
                     *port_http._DEBUG_POST.values()):
            assert callable(getattr(srv.RequestHandlerClass, name)), name
    finally:
        srv.server_close()
    for served_9f in ("/debug/fleet/flight", "/debug/locks",
                      "/debug/races", "/debug/flightrecorder",
                      "/debug/timeseries", "/debug/slo"):
        assert served_9f in DEBUG_ENDPOINTS
        assert served_9f in port_http._DEBUG_GET
    assert "/debug/flightrecorder" in port_http._DEBUG_POST
    assert {"/debug/peers", "/debug/fleet"} <= set(DEBUG_ENDPOINTS)
    assert "torch.profiler" in DEBUG_ENDPOINTS["/debug/profile"]


def test_every_debug_row_answers(served):
    a, base = served
    _post(base + "/query", b'{ q(func: eq(name, "p1")) { name } }')
    for path in DEBUG_ENDPOINTS:
        status, body = _get(base + path)
        assert status == 200, path
        assert body, path
    _, body = _get(base + "/debug")
    assert {e["path"] for e in json.loads(body)["endpoints"]} == \
        set(DEBUG_ENDPOINTS)


def test_debug_memory_is_the_governor_status(served):
    """The HTTP part of test_memgov.py::
    test_debug_memory_endpoint_reports_the_lifecycle: the document is
    the governor's, with a host budget and an injected allocation
    failure that degraded a shape. Every Alpha registers `api.tablet`
    (`server/api.py:_register_tablet_cache`), so it is listed, as in the
    reference's case."""
    a, base = served
    memgov.GOVERNOR.set_budgets(host_bytes=64 << 20)
    memgov.set_alloc_fault(lambda site: site == "dbg.site")
    try:
        with pytest.raises(memgov.OomDegraded):
            memgov.oom_retry("dbg.site", "lanes=32", lambda: None,
                             degrade=True)
    finally:
        memgov.set_alloc_fault(None)
    try:
        _, body = _get(base + "/debug/memory")
        doc = json.loads(body)
        want = json.loads(json.dumps(memgov.GOVERNOR.status()))
        assert doc == want
        assert doc["budgets"]["host"]["budget_bytes"] == 64 << 20
        assert doc["budgets"]["host"]["high_bytes"] == \
            int((64 << 20) * memgov.HIGH_WATERMARK)
        assert {"site": "dbg.site", "shape": "lanes=32",
                "count": 1} in doc["degraded"]
        assert "store.device" in doc["caches"]
        assert "api.tablet" in doc["caches"]
        assert all(set(c) >= {"kind", "bytes", "registrants", "evictions"}
                   for c in doc["caches"].values())
    finally:
        memgov.GOVERNOR.set_budgets()
        memgov.GOVERNOR.reset()


def test_debug_profile_roundtrip_writes_a_chrome_trace(served, tmp_path):
    """The port's counterpart of test_costprofile.py::
    test_debug_profile_roundtrip_produces_loadable_trace: start, a second
    start is 409, a batch inside the window, stop writes a loadable
    Chrome trace, a second stop is 409."""
    a, base = served
    d = str(tmp_path / "prof")
    out = _post(base + "/debug/profile",
                json.dumps({"action": "start", "dir": d}).encode(),
                "application/json")
    assert out["data"] == {"profiling": True, "dir": d}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/debug/profile",
              json.dumps({"action": "start", "dir": d}).encode(),
              "application/json")
    assert ei.value.code == 409
    assert json.loads(_get(base + "/debug/profile")[1])["running"] is True
    a.query_batch(["{ q(func: uid(%d)) @recurse(depth: 3) "
                   "{ friend uid } }" % i for i in range(1, 9)])
    out = _post(base + "/debug/profile",
                json.dumps({"action": "stop"}).encode(), "application/json")
    assert out["data"]["dir"] == d
    (path,) = list((tmp_path / "prof").iterdir())
    assert path.name.startswith("trace-") and path.suffix == ".json"
    assert "traceEvents" in json.loads(path.read_text())
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/debug/profile",
              json.dumps({"action": "stop"}).encode(), "application/json")
    assert ei.value.code == 409


def test_admin_backup_verify_answers_as_verify_chain(tmp_path):
    """The admin-endpoint half of test_backup.py::
    test_verify_cli_and_admin_endpoint on a chain the port wrote (the
    whole case runs in test_torch_cli.py)."""
    from dgraph_tpu_torch.server.backup import verify_chain
    with pytest.MonkeyPatch.context() as m:
        # the reference module's helper, with the port's Alpha and backup
        with bound(test_backup, PORT, m, Transcript(tmp_path)):
            p, dest = test_backup._mk_chain(tmp_path)
            a = test_backup.Alpha.open(p, sync=False)
    srv = port_http.make_http_server(a)
    port_http.serve_background(srv)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/admin/backup/verify",
            data=json.dumps({"dest": dest}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.loads(r.read())
        assert doc["data"]["ok"]
        assert doc["data"] == json.loads(json.dumps(verify_chain(dest)))
    finally:
        srv.shutdown()
        srv.server_close()
        a.wal.close()


def test_concurrent_clients_get_the_single_client_answers(served):
    """8 threads of /query and /query/batch over the CPU engine: every
    answer equals the one a lone client got."""
    a, base = served
    qs = ['{ q(func: eq(name, "p%d")) { name friend { name friend '
          '{ name } } } }' % i for i in range(8)]
    batch = ["{ q(func: uid(%d)) @recurse(depth: 3) { friend uid } }" % i
             for i in range(1, 9)]
    want_q = [_post(base + "/query", q.encode())["data"] for q in qs]
    want_b = _post(base + "/query/batch",
                   json.dumps({"queries": batch}).encode(),
                   "application/json")["data"]
    got, errors = {}, []

    def run(t):
        try:
            for r in range(3):
                i = (t + r) % len(qs)
                got[(t, r)] = (i, _post(base + "/query",
                                        qs[i].encode())["data"])
            got[(t, "b")] = _post(base + "/query/batch",
                                  json.dumps({"queries": batch}).encode(),
                                  "application/json")["data"]
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    for k, v in got.items():
        if k[1] == "b":
            assert v == want_b
        else:
            assert v[1] == want_q[v[0]]
    assert len(got) == 8 * 4
