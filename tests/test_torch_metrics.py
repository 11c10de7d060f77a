"""The port's metrics registry against the reference's, and the counters
the port's engine, store and Alpha emit.

`tests/test_metrics.py`'s cases run with the port's `Registry`,
`BUCKETS_US` and `METRICS` bound in (the harness of
`test_torch_lifecycle.py`), then with the reference's; every
`render()`, `snapshot()`, `hist_snapshot()` and `get()` a case reads is
written to a transcript and the two must be equal. The retrofit tests
drive the same query through both packages and compare the names and
labels each emits at the reference's sites. Tolerance: exact.
"""

import numpy as np
import pytest

import dgraph_tpu.utils.metrics as ref_metrics
import test_metrics
from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.engine import fused as ref_fused
from dgraph_tpu.server.api import Alpha as RefAlpha
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu_torch.engine import Engine, fused
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.utils import metrics
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_lifecycle import PORT, REF, run_reference_case
from test_torch_memgov import reset_cost_state

# graftlint R5 over the package: it runs on the port in test_torch_lint.py
# with the reference's other analyzer cases
SKIP = {"test_every_emitted_metric_name_is_documented"}
# renders whatever the process accumulated so far: only its own
# strictness assertions hold
NONDETERMINISTIC = {"test_global_registry_exposition_is_strict"}
CASES = [n for n in vars(test_metrics)
         if n.startswith("test_") and n not in SKIP]


def _recording_registry(base, log):
    class Rec(base):
        def render(self):
            out = super().render()
            log.append(("render", out))
            return out

        def snapshot(self):
            out = super().snapshot()
            log.append(("snapshot", sorted(
                (k, sorted(v.items())) for k, v in out.items())))
            return out

        def hist_snapshot(self):
            out = super().hist_snapshot()
            log.append(("hist", sorted(out.items())))
            return out

        def get(self, name, **labels):
            out = super().get(name, **labels)
            log.append(("get", name, sorted(labels.items()), out))
            return out
    return Rec


def _run(pkg, name, tmp, monkeypatch):
    log = []
    base = metrics.Registry if pkg == PORT else ref_metrics.Registry
    extra = {"dgraph_tpu.utils.metrics": {
        "Registry": _recording_registry(base, log)}}
    run_reference_case(test_metrics, name, pkg, tmp, monkeypatch,
                       extra=extra)
    return log


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_port(name, tmp_path, monkeypatch):
    port = _run(PORT, name, tmp_path / "port", monkeypatch)
    ref = _run(REF, name, tmp_path / "ref", monkeypatch)
    if name not in NONDETERMINISTIC:
        assert port and port == ref


def test_port_registry_renders_strictly_after_a_query():
    store = _store(StoreBuilder, parse_schema)
    Engine(store, device="cpu", device_threshold=0).query(QUERIES[0])
    test_metrics.check_exposition(METRICS.render())


# -- the retrofitted counters, name and labels ---------------------------------

SCHEMA = ("name: string @index(exact) .\nscore: int @index(int) .\n"
          "friend: [uid] @reverse .")
QUERIES = [
    '{ q(func: ge(score, 8)) { name friend { name friend { score } } } }',
    '{ q(func: has(friend), first: 20) { name friend { friend '
    '{ name } } } }',
]
BATCH = ['{ q(func: uid(0x%x)) @recurse(depth: 3) { uid friend } }' % i
         for i in range(1, 9)] + [
    '{ q(func: uid(0x%x)) { name friend { name friend { name } } } }' % i
    for i in range(1, 9)]


def _store(builder, schema):
    rng = np.random.default_rng(3)
    b = builder(schema(SCHEMA))
    n = 300
    for i in range(1, n + 1):
        b.add_value(i, "name", f"p{i}")
        b.add_value(i, "score", i % 17)
        for j in rng.integers(1, n + 1, 5):
            b.add_edge(i, "friend", int(j))
    return b.finalize()


def _delta(registry, run):
    before = registry.snapshot()["counters"]
    run()
    after = registry.snapshot()["counters"]
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


# names only the reference can emit: its jit cache, pallas kernel, mesh
# and cluster legs (the cost profile, cost prior and memory governor
# emit the reference's names at the reference's sites)
_REF_ONLY = ("jit_", "pallas_", "mesh_", "rpc_", "noquorum")


def _comparable(delta):
    return {k: v for k, v in delta.items()
            if not k.startswith(_REF_ONLY)}


@pytest.fixture
def _fresh_process_state():
    """Both packages' process-wide serving state back to empty: the
    whole-block program memos and their memoized caps (caps another
    file's store left would change how many attempts a call takes on one
    side only), the governor and the cost priors."""
    fused.reset()
    ref_fused.reset()
    reset_cost_state()
    yield
    fused.reset()
    ref_fused.reset()
    reset_cost_state()


@pytest.mark.parametrize("threshold", [0, 10**9])
@pytest.mark.usefixtures("_fresh_process_state")
def test_engine_sites_emit_the_reference_names(threshold, monkeypatch):
    """The same queries through both engines add the same counters, with
    the same labels and the same values: edges per path, the fused
    route, program calls."""
    port_store = _store(StoreBuilder, parse_schema)
    ref_store = _store(RefBuilder, ref_parse_schema)
    port_eng = Engine(port_store, device="cpu", device_threshold=threshold)
    ref_eng = RefEngine(ref_store, device_threshold=threshold)

    def run(eng):
        def go():
            for q in QUERIES * 2:
                eng.query(q)
        return go
    got = _comparable(_delta(METRICS, run(port_eng)))
    want = _comparable(_delta(ref_metrics.METRICS, run(ref_eng)))
    # the reference's program memo is process-wide, the port's per store
    # (ROADMAP Queue 3, memos): each program call is a hit or a miss on
    # both, but which one depends on what ran before
    memo = ("fused_program_hits_total", "fused_program_misses_total")
    assert sum(got.pop(k, 0.0) for k in memo) == \
        sum(want.pop(k, 0.0) for k in memo)
    assert got == want
    assert any(k.startswith("edges_traversed_total") for k in got)
    assert any(k.startswith("fused_route_total") for k in got)


def test_batch_sites_emit_the_reference_names():
    """A mixed batch (a recurse family and a tree family) adds the same
    kernel-group, lane-padding and plan-cache counters on both
    packages; the second identical batch hits the plan cache."""
    port_alpha = Alpha(base=_store(StoreBuilder, parse_schema),
                       device="cpu", device_threshold=0)
    ref_alpha = RefAlpha(base=_store(RefBuilder, ref_parse_schema),
                         device_threshold=0)

    def port():
        assert port_alpha.query_batch(BATCH) == port_alpha.query_batch(BATCH)

    def ref():
        ref_alpha.query_batch(BATCH)
        ref_alpha.query_batch(BATCH)
    keep = ("kernel_group_", "kernel_padded_lanes_total",
            "plan_cache_")
    got = {k: v for k, v in _delta(METRICS, port).items()
           if k.startswith(keep)}
    want = {k: v for k, v in _delta(ref_metrics.METRICS, ref).items()
            if k.startswith(keep)}
    assert got == want
    assert got['plan_cache_hits_total{cache="batch"}'] == 1.0
    assert got['kernel_group_launches_total{family="recurse"}'] == 2.0


def test_alpha_sites_emit_the_reference_names(tmp_path):
    """The same Alpha scenario on both packages — a batch on an
    out-of-core base, a read above its fold, a rollup that carries the
    ELL caches of untouched predicates, a query that fails — adds the same
    `read_view_lazy_tablets_total`, `ell_cache_carried_total` and
    `query_errors_total{lane=}`."""
    names = ("read_view_lazy_tablets_total", "ell_cache_carried_total",
             "query_errors_total")

    def scenario(alpha_cls, p, **kw):
        a = alpha_cls.open(str(p), sync=False, **kw)
        a.alter(SCHEMA)
        a.mutate(set_nquads="\n".join(
            f'<{i:#x}> <name> "p{i}" .\n<{i:#x}> <friend> <{i % 40 + 1:#x}> .'
            for i in range(1, 61)))
        a.checkpoint_to(str(p))
        a.wal.close()
        a = alpha_cls.open(str(p), sync=False, memory_budget=2000, **kw)
        a.query_batch(['{ q(func: uid(0x%x)) @recurse(depth: 2) '
                       '{ uid friend } }' % i for i in range(1, 9)])
        a.mutate(set_nquads='<0x3> <score> "7"^^<xs:int> .')
        a.query('{ q(func: eq(name, "p3")) { name score } }')
        a.maintenance_rollup(str(p))
        with pytest.raises(Exception):
            a.query("{ q(func: eq(name, ) { name } }")
        a.wal.close()

    got = _delta(METRICS, lambda: scenario(
        Alpha, tmp_path / "port", device="cpu"))
    want = _delta(ref_metrics.METRICS, lambda: scenario(
        RefAlpha, tmp_path / "ref"))
    pick = lambda d: {k: v for k, v in d.items()  # noqa: E731
                      if k.startswith(names)}
    assert pick(got) == pick(want)
    assert {k.split("{")[0] for k in pick(got)} == set(names)
