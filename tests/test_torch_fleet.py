"""The port's fleet observability against the reference's.

`tests/test_fleet.py` (trace propagation over the worker transport, one
trace across groups, process-salted span ids, the fleet snapshot's
exact merge and its degraded answer, `/debug/traces?peer=`, the identity
metrics, the instance-labelled exposition, the inbound `X-Trace-Id`)
runs twice through the cluster harness of `test_torch_cluster.py`: the
port's objects bound in, its Alphas on the CPU, then the reference's.
The transcripts must be equal but for ports, ids and clocks
(`test_torch_cluster.normalise`). Left out, each named in ROADMAP Queue
1 item 9f with what it waits for: the flight recorder's cases
(`test_fleet_flight_route_and_peer_proxy`,
`test_watchdog_conviction_names_wedged_peer`, `test_debug_flight_rpc_
direct`) and the CLI's (`test_diagnose_fleet_cli_writes_per_node_files`,
`test_fleet_cli_summary`). Two cases read what the port deliberately
names otherwise or lacks, and run as port counterparts below:
`test_identity_metrics_on_exposition` reads `build_info`'s `jax=` and
`backend=` labels, which the port names `torch=` and `device=` (ROADMAP
Queue 3), and `test_fleet_snapshot_merges_exactly_and_degrades` reads a
node fragment's lock and race `gates`, which come with the lock
sanitizer (9f). `test_propagation_overhead_under_5_percent`, a
wall-clock ratio of the reference's engine on the CPU, is measured for
the port on the card instead (chip_smoke.py phase 12 (e)).
"""

import json
import urllib.request

import pytest

import test_fleet
from dgraph_tpu_torch.cluster import start_cluster_alpha
from dgraph_tpu_torch.cluster.zero import ZeroClient, make_zero_server
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.server.http import make_http_server, serve_background
from dgraph_tpu_torch.utils import costprofile, tracing
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_cluster import compare_cluster_case
from test_torch_lifecycle import reference_cases

SKIP = {"test_identity_metrics_on_exposition",
        "test_fleet_snapshot_merges_exactly_and_degrades",
        "test_fleet_flight_route_and_peer_proxy",
        "test_watchdog_conviction_names_wedged_peer",
        "test_debug_flight_rpc_direct",
        "test_diagnose_fleet_cli_writes_per_node_files",
        "test_fleet_cli_summary"}
# the wall-clock overhead ratio is a CPU timing of the reference's
# engine (it flakes under the suite's six workers); the port's tracing
# overhead is measured on the card (chip_smoke.py phase 12 (e)), as
# for test_tracing.py's own guard (test_torch_tracing.py)
SKIP |= {"test_propagation_overhead_under_5_percent"}
CASES = reference_cases(test_fleet, skip=SKIP)


@pytest.fixture(autouse=True)
def _clean():
    """The reference file's own reset (its autouse fixture), applied to
    the port's cost profile and tracing as well."""
    for mod in (costprofile, test_fleet.costprofile):
        mod.reset()
        mod.set_enabled(True)
    for mod in (tracing, test_fleet.tracing):
        mod.set_enabled(True)
    yield


@pytest.mark.parametrize("name", CASES)
def test_fleet_case_on_port(name, tmp_path, monkeypatch):
    compare_cluster_case(test_fleet, name, tmp_path, monkeypatch)


# -- port counterparts -------------------------------------------------------------

def test_identity_metrics_on_exposition_name_the_torch_build():
    """`build_info` carries the package version, the torch version and
    the device type; `process_uptime_s` is live."""
    alpha = Alpha(device_threshold=10**9, device="cpu")
    srv = make_http_server(alpha)
    serve_background(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(
                base + "/debug/prometheus_metrics") as r:
            text = r.read().decode()
        assert "dgraph_tpu_build_info{" in text
        assert 'version="' in text and 'torch="' in text \
            and 'device="' in text
        up = [ln for ln in text.splitlines()
              if ln.startswith("dgraph_tpu_process_uptime_s")]
        assert up and float(up[0].split()[-1]) >= 0.0
    finally:
        srv.shutdown()


def test_fleet_snapshot_merges_exactly_and_degrades_on_port():
    """The reference case on a port cluster, its `gates` (9f) aside:
    every node's fragment over the worker transport, the cost digests
    merged bit-identically to an in-process merge, the exposition
    instance-labelled, and a dead peer an entry in `errors`, never a
    500."""
    zs, zport, _st = make_zero_server()
    zs.start()
    zt = f"127.0.0.1:{zport}"
    a1, s1, addr1 = start_cluster_alpha(zt, device_threshold=10**9,
                                        device="cpu")
    a2, s2, addr2 = start_cluster_alpha(zt, device_threshold=10**9,
                                        device="cpu")
    zc = ZeroClient(zt)
    for pred in ("name", "age", "dgraph.type"):
        zc.should_serve(pred, a1.groups.gid)
    zc.should_serve("friend", a2.groups.gid)
    a1.alter(test_fleet.SCHEMA)
    a1.groups.refresh()
    a2.groups.refresh()
    a1.mutate(set_nquads='''
      _:a <name> "alice" .
      _:a <age> "29"^^<xs:int> .
      _:b <name> "bob" .
      _:a <friend> _:b .
    ''')
    srv = make_http_server(a1)
    serve_background(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        a1.query(test_fleet.SPAN_Q)
        with urllib.request.urlopen(base + "/debug/fleet") as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert doc["self"] == addr1
        assert set(doc["nodes"]) == {addr1, addr2}
        assert doc["errors"] == {}
        n1 = doc["nodes"][addr1]
        assert n1["build"]["version"] and n1["uptime_s"] >= 0
        assert "spans" in n1 and "breakers" in n1
        frags = {addr1: a1.groups.pool(addr1).debug_fleet(),
                 addr2: a1.groups.pool(addr2).debug_fleet()}
        expect = costprofile.Aggregator()
        for frag in frags.values():
            expect.merge(costprofile.Aggregator.from_state(frag["costs"]))
        assert doc["costs_state"] == json.loads(
            json.dumps(expect.to_state()))
        assert f'instance="{addr1}"' in doc["metrics"]
        assert f'instance="{addr2}"' in doc["metrics"]
        s2.stop(None)
        with urllib.request.urlopen(
                base + "/debug/fleet?budget_ms=1500") as r:
            assert r.status == 200
            down = json.loads(r.read())
        assert addr1 in down["nodes"] and addr2 not in down["nodes"]
        assert addr2 in down["errors"]
        assert down["costs"]["records_total"] >= 0
        assert METRICS.get("fleet_fanout_total", outcome="error") >= 1
    finally:
        srv.shutdown()
        for s in (s1, s2, zs):
            s.stop(None)
