"""Mesh serving on the port against the reference, on CPU shards.

Every case of the reference's `test_mesh_serving.py` runs on the port:
its in-process cases through the lifecycle harness
(`test_torch_lifecycle.py`, `make_mesh` bound to `make_mesh(n,
device="cpu")` and `Executor` to the CPU on the port's run); its
4-device subprocess child as a port child on 4 CPU shards whose answers
must equal the reference's single-device engine in this process; its
`hop_input` case, which places JAX arrays, as a twin. So do the mesh
cases of `test_vec.py` (a 4-shard child, the knn_mesh route) and
`test_server.py` (the served mesh engine over gRPC, the CLI's flag).
The port's own cases add `@msgpass` through `feat_mesh`, an ACL view on
a mesh, a fold's carry of the sharded tablets and a `store.sharded`
eviction and re-placement. Tolerance: answers, ranks, counts and
`needs` exact; `@msgpass` sum and mean to rtol=1e-5, atol=1e-6 against
the reference and against the port's single-device route, max exact.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import test_mesh_serving
import test_server
from test_torch_lifecycle import (PORT, REF, run_reference_case,
                                  settled_threads)  # noqa: F401
from test_torch_memgov import reset_cost_state

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.models.synthetic import powerlaw_rel as ref_powerlaw
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.engine.batch import carry_mesh_residency
from dgraph_tpu_torch.engine.execute import Executor
from dgraph_tpu_torch.parallel import mesh
from dgraph_tpu_torch.server.acl import AclView
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.utils import memgov
from dgraph_tpu_torch.utils.metrics import METRICS

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    reset_cost_state()
    yield
    reset_cost_state()


def cpu_mesh(n_devices=None, devices=None):
    return mesh.make_mesh(n_devices, devices, device=CPU)


class CpuExecutor(Executor):
    def __init__(self, store, *a, device=CPU, **kw):
        super().__init__(store, *a, device=device, **kw)


CPU_BINDINGS = {"dgraph_tpu.parallel.mesh": {"make_mesh": cpu_mesh},
                "dgraph_tpu.engine.execute": {"Executor": CpuExecutor}}


def cpu_bindings(pkg, tr):
    return CPU_BINDINGS if pkg == PORT else {}


def compare_mesh_case(module, name, tmp_path, monkeypatch, **kw):
    """Both runs of one reference case, cost state reset before each;
    their transcripts must be equal."""
    logs = []
    for pkg in (PORT, REF):
        reset_cost_state()
        logs.append(run_reference_case(module, name, pkg, tmp_path / pkg,
                                       monkeypatch, extra=cpu_bindings,
                                       **kw))
    assert logs[0] == logs[1]


# -- test_mesh_serving.py ----------------------------------------------------------

HARNESS_CASES = [
    "test_chain_recurse_matches_scan_and_host",
    "test_sharded_residency_gauges_and_cache",
    "test_mesh_residency_carries_across_fold",
    "test_route_promotion_follows_learned_costs",
    "test_mesh_expansion_records_shard_costs",
    "test_debug_scheduler_surfaces_mesh_shard_costs",
]
# the reference's case → the port's twin in this file
TWINS = {
    "test_sharded_hops_bit_identical_on_4_virtual_devices":
        "test_sharded_hops_bit_identical_on_4_cpu_shards",
    "test_hop_input_counts_mismatched_sharding":
        "test_hop_input_counts_mismatched_placement",
}


@pytest.mark.parametrize("name", HARNESS_CASES)
def test_mesh_serving_case_on_port(name, tmp_path, monkeypatch):
    compare_mesh_case(test_mesh_serving, name, tmp_path, monkeypatch)


def test_mesh_serving_cases_all_covered():
    cases = {n for n in dir(test_mesh_serving) if n.startswith("test_")}
    assert cases == set(HARNESS_CASES) | set(TWINS)
    assert all(n in globals() for n in TWINS.values())


_SERVING_QUERIES = [
    '{ q(func: uid(0x1, 0x5, 0x9)) { uid friend { uid } } }',
    '{ q(func: eq(name, "p7")) { name friend { name friend { name } } } }',
    '{ r(func: uid(0x2)) @recurse(depth: 4) { uid friend } }',
    '{ q(func: uid(0x3)) { friend { friend { uid } } ~friend { uid } } }',
]

_CHILD = textwrap.dedent("""\
    import json, sys
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.models.synthetic import powerlaw_rel
    from dgraph_tpu_torch.parallel.mesh import make_mesh, reshard_count
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder

    rel = powerlaw_rel(400, 4.0, seed=7)
    b = StoreBuilder(parse_schema(
        "friend: [uid] @reverse .\\nname: string @index(exact) ."))
    for s in range(rel.indptr.shape[0] - 1):
        b.add_value(s + 1, "name", f"p{s}")
        for o in rel.row(s):
            b.add_edge(s + 1, "friend", int(o) + 1)
    st = b.finalize()
    host = Engine(st, device="cpu", device_threshold=10**9)
    mesh = Engine(st, device="cpu", device_threshold=0,
                  mesh=make_mesh(4, device="cpu"))
    answers = []
    for q in json.loads(sys.argv[1]):
        a, b_ = host.query(q), mesh.query(q)
        assert a == b_, (q, a, b_)
        answers.append(b_)
    assert reshard_count() == 0, reshard_count()
    assert mesh.routes.expansions["mesh_chain"] >= 1
    assert not any(m == "jax" or m.startswith(("jax.", "dgraph_tpu."))
                   for m in sys.modules)
    print(json.dumps(answers))
    print("PASS 4 shards bit-identity reshard-free", flush=True)
""")


def _run_child(code, *args):
    proc = subprocess.run([sys.executable, "-c", code, *args],
                          capture_output=True, text=True, cwd=str(ROOT),
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def _ref_friend_store():
    rel = ref_powerlaw(400, 4.0, seed=7)
    b = RefBuilder(ref_parse_schema(
        "friend: [uid] @reverse .\nname: string @index(exact) ."))
    for s in range(rel.indptr.shape[0] - 1):
        b.add_value(s + 1, "name", f"p{s}")
        for o in rel.row(s):
            b.add_edge(s + 1, "friend", int(o) + 1)
    return b.finalize()


def test_sharded_hops_bit_identical_on_4_cpu_shards():
    """The reference's 4-device acceptance child, as a port child on 4
    CPU shards: every answer equals the port's host route there and the
    reference's single-device engine here, with no reshard."""
    out = _run_child(_CHILD, json.dumps(_SERVING_QUERIES))
    assert out[-1] == "PASS 4 shards bit-identity reshard-free"
    ref = RefEngine(_ref_friend_store(), device_threshold=10**9)
    assert json.loads(out[-2]) == [ref.query(q) for q in _SERVING_QUERIES]


def test_hop_input_counts_mismatched_placement():
    """The reference's hop_input case: a host seed and a value placed
    replicated on the mesh do not count; a value off the mesh's devices
    counts one reshard, and the guard raises."""
    m = mesh.make_mesh(4, device=CPU)
    before = mesh.reshard_count()
    mesh.hop_input(np.arange(8, dtype=np.int32), m)          # host seed
    mesh.hop_input(mesh.device_put(np.arange(8, dtype=np.int32),
                                   mesh.replicated(m)), m)   # chained
    mesh.hop_input(mesh.shard(m, np.zeros((4, 2))), m, mesh.SHARDED)
    assert mesh.reshard_count() == before
    stray = torch.arange(8, dtype=torch.int32, device="meta")
    with pytest.raises(AssertionError, match="reshard"):
        with mesh.reshard_guard():
            mesh.hop_input(stray, m)
    assert mesh.reshard_count() == before + 1
    # sharded where replicated is expected, and the reverse
    mesh.hop_input(mesh.shard(m, np.zeros((4, 2))), m)
    mesh.hop_input(mesh.replicate(m, np.zeros(2)), m, mesh.SHARDED)
    assert mesh.reshard_count() == before + 3


# -- test_vec.py's mesh case -----------------------------------------------------------

_VEC_QUERIES = [
    '{ q(func: similar_to(emb, 6, "[1, 0, 2, 1]")) { uid friend { uid } } }',
    '{ q(func: similar_to(emb, 3, 9)) @recurse(depth: 3) { uid friend } }',
    '{ q(func: similar_to(emb, 50, "[2, 2, 0, 1]")) { uid } }',
]

_VEC_CHILD = textwrap.dedent("""\
    import json, sys
    import numpy as np
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.parallel.mesh import make_mesh, reshard_count
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder
    from dgraph_tpu_torch.utils.metrics import METRICS

    rng = np.random.default_rng(3)
    b = StoreBuilder(parse_schema(
        "emb: float32vector @dim(4) .\\nfriend: [uid] @reverse ."))
    for i in range(1, 51):
        b.add_value(i, "emb", [int(x) for x in rng.integers(0, 5, 4)])
        for j in rng.integers(1, 51, 3):
            if i != int(j):
                b.add_edge(i, "friend", int(j))
    st = b.finalize()
    host = Engine(st, device="cpu", device_threshold=10**9)
    mesh = Engine(st, device="cpu", device_threshold=0,
                  mesh=make_mesh(4, device="cpu"))
    answers = []
    for q in json.loads(sys.argv[1]):
        a, b_ = host.query(q), mesh.query(q)
        assert a == b_, (q, a, b_)
        answers.append(b_)
    assert METRICS.get("knn_route_total", route="mesh") >= 3
    assert reshard_count() == 0, reshard_count()
    print(json.dumps(answers))
    print("PASS 4 shards knn bit-identity reshard-free", flush=True)
""")


def test_mesh_knn_bit_identical_on_4_cpu_shards():
    """test_vec.py::test_mesh_knn_bit_identical_on_4_virtual_devices as a
    port child on 4 CPU shards, held against the reference here."""
    out = _run_child(_VEC_CHILD, json.dumps(_VEC_QUERIES))
    assert out[-1] == "PASS 4 shards knn bit-identity reshard-free"
    rng = np.random.default_rng(3)
    b = RefBuilder(ref_parse_schema(
        "emb: float32vector @dim(4) .\nfriend: [uid] @reverse ."))
    for i in range(1, 51):
        b.add_value(i, "emb", [int(x) for x in rng.integers(0, 5, 4)])
        for j in rng.integers(1, 51, 3):
            if i != int(j):
                b.add_edge(i, "friend", int(j))
    ref = RefEngine(b.finalize(), device_threshold=10**9)
    assert json.loads(out[-2]) == [ref.query(q) for q in _VEC_QUERIES]


# -- test_server.py's mesh cases --------------------------------------------------------

SERVER_CASES = ["test_served_mesh_engine_identical_json", "test_cli_mesh_flag"]


@pytest.mark.parametrize("name", SERVER_CASES)
def test_server_mesh_case_on_port(name, tmp_path, monkeypatch, capsys):
    compare_mesh_case(test_server, name, tmp_path, monkeypatch,
                      fixtures={"capsys": capsys})


def test_server_mesh_cases_all_covered():
    assert {n for n in dir(test_server)
            if n.startswith("test_") and "mesh" in n} == set(SERVER_CASES)


# -- the port's own cases ------------------------------------------------------------

FEAT_SCHEMA = ("emb: float32vector @dim(8) .\nfriend: [uid] @reverse .\n"
               "name: string @index(exact) .")


def _feat_rows(n=120, seed=9):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, 8)).astype(np.float32)
    edges = [(i, int(j)) for i in range(1, n + 1)
             for j in rng.integers(1, n + 1, 4) if i != int(j)]
    return vecs, edges


def _feat_store(make, parse, n=120, seed=9):
    vecs, edges = _feat_rows(n, seed)
    b = make(parse(FEAT_SCHEMA))
    for i in range(1, n + 1):
        b.add_value(i, "name", f"p{i}")
        if i % 5:                       # a fifth of the nodes have no row
            b.add_value(i, "emb", [float(x) for x in vecs[i - 1]])
    for i, j in edges:
        b.add_edge(i, "friend", j)
    return b.finalize()


FEAT_QUERIES = {
    agg: [f'{{ q(func: uid(0x1, 0x2, 0x3)) @msgpass(pred: emb, agg: {agg})'
          f' {{ uid friend {{ uid }} }} }}',
          f'{{ q(func: uid(0x4)) @recurse(depth: 3) @msgpass(pred: emb, '
          f'agg: {agg}) {{ uid friend }} }}']
    for agg in ("sum", "mean", "max")}


def _close(a, b, exact):
    """JSON answers equal, floats within the stated tolerance (or
    exactly)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], exact)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, exact)
    elif isinstance(a, float):
        if exact:
            assert a == b
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    else:
        assert a == b


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_msgpass_feat_mesh_route(agg):
    """@msgpass through the feat_mesh route on 8 CPU shards: max exact,
    sum and mean to rtol=1e-5, atol=1e-6 against the reference's host
    route and the port's single-device route."""
    ref = RefEngine(_feat_store(RefBuilder, ref_parse_schema),
                    device_threshold=10**9)
    st = _feat_store(StoreBuilder, parse_schema)
    single = Engine(st, device=CPU, device_threshold=0)
    on_mesh = Engine(st, device=CPU, device_threshold=0,
                     mesh=mesh.make_mesh(8, device=CPU))
    before = METRICS.get("feat_route_total", route="mesh")
    for q in FEAT_QUERIES[agg]:
        got = on_mesh.query(q)
        _close(ref.query(q), got, exact=agg == "max")
        _close(single.query(q), got, exact=agg == "max")
    assert METRICS.get("feat_route_total", route="mesh") - before == 2
    assert on_mesh.routes.expansions["mesh_chain"] >= 1


def _acl_alpha(m):
    a = Alpha(device=CPU, device_threshold=0, mesh=m)
    a.alter("friend: [uid] @reverse .\nsecret: [uid] .\n"
            "name: string @index(exact) .\nscore: int .")
    a.mutate(set_nquads="\n".join(
        f'_:p{i} <name> "p{i}" .\n_:p{i} <score> "{i % 7}"^^<xs:int> .\n'
        f'_:p{i} <friend> _:p{(i * 3 + 1) % 40} .\n'
        f'_:p{i} <secret> _:p{(i * 5 + 2) % 40} .' for i in range(40)))
    return a


def test_acl_view_on_a_mesh_shares_only_readable_tablets():
    """A restricted view on a mesh: its readable tablets and key columns
    are the snapshot's (placed once), a hidden predicate reads as empty
    and what the view places for it stays on the view."""
    m = mesh.make_mesh(4, device=CPU)
    a = _acl_alpha(m)
    q = ('{ q(func: has(name), orderasc: score, first: 12) '
         '{ name friend (orderdesc: score) { name } secret { name } } }')
    base = a.mvcc.read_view(a.oracle.read_ts())
    view = AclView(base, {"name", "friend", "score"})
    got = Engine(view, device=CPU, device_threshold=0, mesh=m).query(q)
    want = Engine(view, device=CPU, device_threshold=10**9).query(q)
    assert got == want
    assert all("secret" not in r for r in got["q"])
    assert ("friend", "fwd") in base._sharded
    assert ("secret", "fwd") not in base._sharded and not view._sharded
    assert base._key_cols.get(("score", "")) is not None
    assert view.sharded_rel("friend", False, m) is \
        base.sharded_rel("friend", False, m)
    assert not view._key_cols


def test_fold_carries_untouched_sharded_tablets():
    """A rollup hands the new snapshot the placed shard stacks of the
    predicates its layers did not touch, and drops the touched ones."""
    m = mesh.make_mesh(4, device=CPU)
    a = _acl_alpha(m)
    q = '{ q(func: eq(name, "p1")) { friend { secret { name } } } }'
    a.query(q)
    old = a.mvcc.read_view(a.oracle.read_ts())
    assert {("friend", "fwd"), ("secret", "fwd")} <= set(old._sharded)
    friend = old._sharded[("friend", "fwd")]
    carried0 = METRICS.get("mesh_resident_carried_total")
    u1, u2 = (a.query('{ q(func: eq(name, "%s")) { uid } }' % n)["q"][0][
        "uid"] for n in ("p1", "p2"))
    a.mutate(set_nquads=f'<{u1}> <secret> <{u2}> .')
    a.maintenance_rollup()
    new = a.mvcc.read_view(a.oracle.read_ts())
    assert new is not old
    assert new._sharded.get(("friend", "fwd")) is friend
    assert ("secret", "fwd") not in new._sharded
    assert METRICS.get("mesh_resident_carried_total") > carried0
    assert new.sharded_rel("friend", False, m) is friend
    plain = Alpha(base=a.mvcc.read_view(a.oracle.read_ts()), device=CPU,
                  device_threshold=0)
    assert a.query(q) == plain.query(q)


def test_store_sharded_eviction_places_again():
    """The device budget evicts `store.sharded` tablets; the next use
    places them again (counted) and the answers do not change."""
    m = mesh.make_mesh(4, device=CPU)
    a = _acl_alpha(m)
    q = ('{ q(func: has(name), first: 30) '
         '{ name friend { name ~friend { name } } } }')
    want = a.query(q)
    st = a.mvcc.read_view(a.oracle.read_ts())
    assert st._sharded
    placed0 = METRICS.get("cache_replacements_total", cache="store.sharded")
    memgov.GOVERNOR.set_budgets(device_bytes=1)
    try:
        memgov.GOVERNOR.maybe_evict("device")
        assert not st._sharded
        assert a.query(q) == want
        assert METRICS.get("cache_replacements_total",
                           cache="store.sharded") > placed0
        assert memgov.GOVERNOR.status()["caches"]["store.sharded"][
            "evictions"] > 0
    finally:
        memgov.GOVERNOR.set_budgets(device_bytes=0, host_bytes=0)


def test_mesh_of_another_device_type_raises():
    """An engine on one device type refuses a mesh of another."""
    from dgraph_tpu_torch.engine.execute import check_mesh
    with pytest.raises(ValueError, match="mesh of cpu devices"):
        check_mesh(mesh.make_mesh(2, device=CPU), torch.device("cuda", 0))
    m = mesh.make_mesh(2, device=CPU)
    assert check_mesh(m, torch.device(CPU)) is m
