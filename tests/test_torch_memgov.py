"""The port's memory governor against the reference's.

`tests/test_memgov.py`'s cases run with the port's objects bound in (the
harness of `test_torch_lifecycle.py`: `Governor`, `GOVERNOR`,
`AllocFault`, `OomDegraded`, the watermarks, the port's `Engine` on the
CPU and its `StoreBuilder`), then with the reference's; their transcripts
must be equal and each run's own assertions hold. So do `test_vec.py`'s
and `test_feat.py`'s allocation-fault and eviction cases. Tolerance:
exact.

Deliberate differences: the port classifies an allocation failure by
type (`torch.cuda.OutOfMemoryError`), never by the text of an arbitrary
error, so the reference's classification case has a port counterpart
here; the reference's overhead guard is a wall-clock ratio, and its port
counterpart counts the governor's work instead (callbacks per unarmed
fill, evictions per armed uncontended fill). After a failed retry the
reference serves `hop.*`, `vec.topk` and `feat.agg` from the host; the
port degrades only `fused.program`, to the staged torch ops on the same
device, and raises at every other site, so the reference's host-degrade
cases run the port's counterparts under their own names
(`PORT_POLICY`), and its sticky-degrade case runs `oom_retry` as a
degrading site calls it, as does the flight-bundle case. The HTTP part
of the `/debug/memory` case runs in `test_torch_http.py`.
"""

import functools
import json

import numpy as np
import pytest
import torch

import dgraph_tpu.utils.costprior as ref_costprior
import dgraph_tpu.utils.costprofile as ref_costprofile
import dgraph_tpu.utils.memgov as ref_memgov
import test_feat
import test_memgov
import test_vec
from dgraph_tpu_torch.engine import Engine, fused
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store import vec
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.utils import costprior, costprofile, memgov
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_lifecycle import PORT, REF, run_reference_case


def reset_cost_state():
    """Both packages' process-wide governor, allocation-fault hook, cost
    profile and priors back to empty: the route EMAs promote routes and
    a degraded shape sticks, so a test must not inherit another's."""
    for gov, prior, prof in ((memgov, costprior, costprofile),
                             (ref_memgov, ref_costprior, ref_costprofile)):
        gov.set_alloc_fault(None)
        gov.GOVERNOR.reset()
        prior.reset()
        prior.set_enabled(True)
        prof.reset()
        prof.set_enabled(True)


@pytest.fixture(autouse=True)
def _clean():
    reset_cost_state()
    yield
    reset_cost_state()


def _compare(module, name, tmp_path, monkeypatch, port_extra=None):
    """Run one reference case on each package (state reset before each
    run); the transcripts must be equal."""
    port = run_reference_case(module, name, PORT, tmp_path / "port",
                              monkeypatch, extra=port_extra)
    reset_cost_state()
    ref = run_reference_case(module, name, REF, tmp_path / "ref",
                             monkeypatch)
    assert port == ref


# -- test_memgov.py ------------------------------------------------------------

MEMGOV_CASES = [
    "test_eviction_orders_by_recompute_value_per_byte",
    "test_unknown_cache_name_refused",
    "test_oom_retry_absorbs_single_failure_with_one_evict_pass",
    "test_oom_retry_sticky_degrades_on_repeat",
    "test_non_alloc_errors_pass_through_untouched",
    "test_degraded_route_is_bit_identical_to_device_route",
    "test_flight_bundle_carries_the_memory_surface",
]


# the cases' `oom_retry` is a site's with a degraded route on the card
DEGRADING_CASES = {"test_oom_retry_sticky_degrades_on_repeat",
                   "test_flight_bundle_carries_the_memory_surface"}
DEGRADING = {"dgraph_tpu.utils.memgov": {
    "oom_retry": functools.partial(memgov.oom_retry, degrade=True)}}


@pytest.mark.parametrize("name", MEMGOV_CASES)
def test_memgov_case_on_port(name, tmp_path, monkeypatch):
    if name in PORT_POLICY:
        PORT_POLICY[name](monkeypatch)
        return
    _compare(test_memgov, name, tmp_path, monkeypatch,
             port_extra=DEGRADING if name in DEGRADING_CASES else None)


def test_is_alloc_failure_classification():
    """The port's counterpart of the reference's classification case:
    by type. The caching allocator's error, an injected fault and a
    MemoryError are allocation failures; a CUDA launch error, an illegal
    address, a RuntimeError that merely says "out of memory", a kernel
    build failure and an assertion are not."""
    assert memgov.is_alloc_failure(memgov.AllocFault("x"))
    assert memgov.is_alloc_failure(MemoryError())
    assert memgov.is_alloc_failure(
        torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert memgov.is_alloc_failure(torch.OutOfMemoryError("x"))
    for e in (RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
              RuntimeError("CUDA error: out of memory"),
              RuntimeError("kernel build failed:\nbucket_hop: nvcc exited 1"),
              AssertionError("bit mismatch"),
              ValueError("out of memory")):
        assert not memgov.is_alloc_failure(e), e


def test_non_alloc_runtime_error_raises_through_oom_retry():
    """A RuntimeError with an out-of-memory message is not classified:
    `oom_retry` lets it through on the first call, with no retry, no
    event and no degrade."""
    calls = []

    def fail():
        calls.append(1)
        raise RuntimeError("CUDA error: out of memory")

    with pytest.raises(RuntimeError):
        memgov.oom_retry("t.site", "s", fail)
    assert calls == [1]
    assert memgov.GOVERNOR.oom_stats() == {"events": 0, "retries": 0,
                                           "degraded": 0}


def test_real_oom_is_retried_once_then_degrades():
    """The allocator's own error takes the lifecycle: absorbed by one
    retry; on a second failure it goes to the caller (logged, nothing
    sticks), or, at a site with a degraded route on the card, it
    degrades the shape."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 7

    assert memgov.oom_retry("t.site", "a", flaky) == 7
    assert memgov.GOVERNOR.oom_stats() == {"events": 1, "retries": 1,
                                           "degraded": 0}

    def always():
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    del calls[:]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        memgov.oom_retry("t.site", "b", always)
    assert len(calls) == 2 and not memgov.GOVERNOR.is_degraded("t.site", "b")
    assert memgov.GOVERNOR.oom_stats()["degraded"] == 0
    with pytest.raises(memgov.OomDegraded):
        memgov.oom_retry("t.site", "b", always, degrade=True)
    assert memgov.GOVERNOR.is_degraded("t.site", "b")
    assert METRICS.snapshot()["gauges"]["oom_degraded"] == 1.0
    assert METRICS.get("oom_events_total", site="t.site") >= 3
    # sticky: the degraded shape is refused before its launch runs
    del calls[:]
    with pytest.raises(memgov.OomDegraded):
        memgov.oom_retry("t.site", "b", always, degrade=True)
    assert not calls


def test_estimate_nbytes_counts_tensors_by_elements():
    t = torch.zeros((3, 5), dtype=torch.int32)
    a = np.zeros(7, np.float64)
    assert memgov.estimate_nbytes(t) == 60
    assert memgov.estimate_nbytes((t, [a, {"k": t[:1]}])) == 60 + 56 + 20


def test_governed_caches_are_the_ports():
    """The inventory names exactly the caches the port has, and each is
    registered once the modules that hold them are in use."""
    assert set(memgov.GOVERNED_CACHES) == {
        "fused.program", "batch.plan", "batch.ell", "batch.ell_dev",
        "batch.kernel", "store.device", "store.sharded", "api.tablet",
        "outofcore.resident", "store.vec", "timeseries.ring"}
    assert set(memgov.GOVERNED_CACHES) == set(ref_memgov.GOVERNED_CACHES)
    a = Alpha(device="cpu", device_threshold=0)
    a.alter("friend: [uid] @reverse .")
    a.mutate(set_nquads="\n".join(f"<{i}> <friend> <{i % 9 + 1}> ."
                                  for i in range(1, 10)))
    a.query_batch(["{ q(func: uid(%d)) @recurse(depth: 2) { friend } }" % i
                   for i in range(1, 6)])
    names = memgov.GOVERNOR.registered_names()
    assert {"fused.program", "batch.plan", "batch.ell", "batch.ell_dev",
            "batch.kernel", "store.device", "store.sharded",
            "store.vec"} <= names


def _friend_store(n=512):
    rng = np.random.default_rng(7)
    b = StoreBuilder(parse_schema(
        "name: string @index(exact) .\nfriend: [uid] @reverse ."))
    for i in range(1, n + 1):
        b.add_value(i, "name", f"p{i}")
        for j in rng.integers(1, n + 1, 4):
            b.add_edge(i, "friend", int(j))
    return b.finalize()


class _Counted:
    """A governed cache stub that counts the governor's calls."""

    def __init__(self):
        self.bytes_calls = self.evict_calls = 0

    def nbytes(self):
        self.bytes_calls += 1
        return 1 << 20

    def evict_one(self):
        self.evict_calls += 1
        return 0


def test_governor_overhead_counts_work_not_time():
    """The port's counterpart of the reference's 5 % overhead guard,
    counted instead of timed: an UNARMED governor makes no callback on
    the hot query path (one attribute read per fill), and an armed,
    uncontended one (budgets far above the working set) evicts nothing
    and stays byte-identical. Queries on the device route fill
    `store.device` and the ELL caches, so every fill site is crossed."""
    store = _friend_store()
    eng = Engine(store, device="cpu", device_threshold=0)
    queries = [
        '{ q(func: eq(name, "p9")) { name friend { name } } }',
        '{ q(func: has(friend), first: 20) { name friend { friend '
        '{ name } } } }',
    ]
    want = [eng.query(q) for q in queries]
    ooms = METRICS.get("oom_events_total", site="hop.gather_edges")
    stub = _Counted()
    memgov.GOVERNOR.register("api.tablet", "host", stub.nbytes,
                             stub.evict_one, owner=stub)
    memgov.GOVERNOR.set_budgets(0, 0)
    fresh = Engine(_friend_store(), device="cpu", device_threshold=0)
    assert [fresh.query(q) for q in queries] == want
    assert stub.bytes_calls == 0 and stub.evict_calls == 0
    memgov.GOVERNOR.set_budgets(device_bytes=1 << 40, host_bytes=1 << 40)
    fresh = Engine(_friend_store(), device="cpu", device_threshold=0)
    assert [fresh.query(q) for q in queries] == want
    assert stub.evict_calls == 0
    assert sum(memgov.GOVERNOR.evictions().values()) == 0
    assert METRICS.get("oom_events_total", site="hop.gather_edges") == ooms


def test_status_reports_caches_budgets_and_lifecycle():
    store = _friend_store(n=64)
    eng = Engine(store, device="cpu", device_threshold=0)
    eng.query('{ q(func: has(friend)) { friend { uid } } }')
    memgov.GOVERNOR.set_budgets(device_bytes=10 << 20)
    st = memgov.GOVERNOR.status()
    assert st["budgets"]["device"]["budget_bytes"] == 10 << 20
    assert st["budgets"]["device"]["high_bytes"] == int(
        (10 << 20) * memgov.HIGH_WATERMARK)
    assert st["caches"]["store.device"]["bytes"] >= \
        store.rel("friend").indices.nbytes
    assert st["caches"]["store.device"]["kind"] == "device"
    assert st["oom"] == {"events": 0, "retries": 0}
    assert st["degraded"] == [] and st["pressure"] is None


def test_evicted_device_csr_replaces_and_counts():
    """`store.device` entries evicted under a device budget are placed
    again on next use, counted per cache, with byte-identical answers."""
    store = _friend_store(n=64)
    eng = Engine(store, device="cpu", device_threshold=0)
    q = '{ q(func: has(friend)) { friend { friend { uid } } } }'
    want = eng.query(q)
    assert store._device
    r0 = METRICS.get("cache_replacements_total", cache="store.device")
    memgov.GOVERNOR.set_budgets(device_bytes=1)
    try:
        memgov.GOVERNOR.evict_to_low("device")
    finally:
        memgov.GOVERNOR.set_budgets()
    assert not store._device
    assert METRICS.get("cache_evictions_total", cache="store.device") >= 1
    assert eng.query(q) == want
    assert store._device
    assert METRICS.get("cache_replacements_total",
                       cache="store.device") >= r0 + 1


def test_evicting_a_placed_csr_drops_the_programs_that_read_it():
    """A whole-block program holds the `store.device` tensors it reads:
    evicting them also drops the program (or the eviction would free
    nothing and the next placement would be a second copy), and the next
    call builds one on the tensors placed again."""
    store = _friend_store(n=64)
    eng = Engine(store, device="cpu", device_threshold=0)
    q = '{ q(func: uid(1, 2)) { friend { friend { uid } } } }'
    want = eng.query(q)

    def readers():
        placed = list(store._device.values())
        return [p for p in fused._programs.values()
                if any(r is v for r in p.rels for v in placed)]

    progs = readers()
    assert progs
    memgov.GOVERNOR.set_budgets(device_bytes=1)
    try:
        memgov.GOVERNOR.evict_to_low("device")
    finally:
        memgov.GOVERNOR.set_budgets()
    assert not store._device
    assert not any(p.held for p in progs)
    assert not any(p in fused._programs.values() for p in progs)
    assert eng.query(q) == want
    assert readers() and not set(map(id, readers())) & set(map(id, progs))


# -- test_vec.py and test_feat.py: allocation faults and eviction ---------------

def _cpu_similar(fn):
    def similar_ranks(store, f, mesh=None, device_threshold=512):
        return fn(store, f, "cpu", device_threshold)
    return similar_ranks


VEC_CASES = ["test_evicted_vec_stack_replaces_on_next_use",
             "test_alloc_fault_evict_retry_is_bit_identical",
             "test_persistent_alloc_fault_degrades_to_host_bit_identically",
             "test_fused_knn_under_alloc_fault_serves_host_bit_identically"]
FEAT_CASES = ["test_alloc_fault_at_feat_agg_absorbed_by_evict_retry",
              "test_persistent_feat_fault_degrades_to_host_and_sticks",
              "test_vec_replacement_meter_and_memory_detail"]


@pytest.mark.parametrize("name", VEC_CASES)
def test_vec_case_on_port(name, tmp_path, monkeypatch):
    if name in PORT_POLICY:
        PORT_POLICY[name](monkeypatch)
        return
    # the port's routed top-k takes its device as an argument
    extra = {"dgraph_tpu.store.vec": {
        "similar_ranks": _cpu_similar(vec.similar_ranks)}}
    _compare(test_vec, name, tmp_path, monkeypatch, port_extra=extra)


@pytest.mark.parametrize("name", FEAT_CASES)
def test_feat_case_on_port(name, tmp_path, monkeypatch):
    if name in PORT_POLICY:
        PORT_POLICY[name](monkeypatch)
        return
    _compare(test_feat, name, tmp_path, monkeypatch)


# -- the port's counterparts of the reference's host-degrade cases ---------------

def _port_store(module, helper, **kw):
    """A reference test module's store helper, built by the port."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(module, "StoreBuilder", StoreBuilder)
        m.setattr(module, "parse_schema", parse_schema)
        return getattr(module, helper)(**kw)


def _inject(*prefixes):
    memgov.set_alloc_fault(lambda site: site.startswith(prefixes))


def _fails_without_host_route(run, sites: int = 1):
    """`run()` under a persistent fault: the allocation failure raises
    after `sites` evict-and-retries, and nothing degrades."""
    before = memgov.GOVERNOR.oom_stats()
    with pytest.raises(memgov.AllocFault):
        run()
    after = memgov.GOVERNOR.oom_stats()
    assert after["events"] == before["events"] + sites
    assert after["degraded"] == before["degraded"]


def _degrade_on_the_same_device(monkeypatch):
    """`test_memgov.py::test_degraded_route_is_bit_identical_to_device_
    route` on the port: a persistent fault at `fused.program` degrades
    the shape to the staged route on the same device, bit-identical and
    sticky until reset; one at `hop.gather_edges` or `vec.topk` raises
    out of the query, serves nothing from the host and leaves nothing
    degraded, so the device route serves once the fault is gone."""
    store = _port_store(test_memgov, "_friend_store")
    q = '{ q(func: uid(1)) { friend { friend { friend { uid } } } } }'
    qv = ('{ q(func: similar_to(emb, 5, "[1, 0, 2, 1]")) '
          '{ uid friend { uid } } }')
    dev = Engine(store, device="cpu", device_threshold=1)
    want, want_v = dev.query(q), dev.query(qv)
    _inject("fused.")
    deg = Engine(store, device="cpu", device_threshold=1)
    assert json.dumps(deg.query(q)) == json.dumps(want)
    assert json.dumps(deg.query(qv)) == json.dumps(want_v)
    assert memgov.GOVERNOR.oom_stats()["degraded"] == 2
    memgov.set_alloc_fault(None)
    fb = fused.status()["routes"]["fallback"]
    assert deg.query(q) == want and deg.query(qv) == want_v
    assert fused.status()["routes"]["fallback"] == fb + 2
    memgov.GOVERNOR.reset()
    # staged: an ordered hop gathers through `hop.gather_edges`
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    qo = '{ q(func: uid(1, 2, 3)) { friend (orderasc: name) { uid } } }'
    want_o = dev.query(qo)
    _inject("hop.", "vec.")
    _fails_without_host_route(lambda: deg.query(qo))
    _fails_without_host_route(lambda: deg.query(qv))
    memgov.set_alloc_fault(None)
    assert deg.query(qo) == want_o and deg.query(qv) == want_v


def _vec_fault_raises(monkeypatch):
    """`test_vec.py::test_persistent_alloc_fault_degrades_to_host_bit_
    identically` on the port: the device top-k's failed retry raises;
    the host scan serves nothing in its place, and the device route
    serves the same set once the fault is gone."""
    st = _port_store(test_vec, "_vec_store", n=48)
    f = test_vec._func(6, [2, 1, 0, 1])
    want = vec.similar_ranks(st, f, "cpu", device_threshold=0).tolist()
    _inject("vec.")
    host0 = METRICS.get("knn_route_total", route="host")
    _fails_without_host_route(
        lambda: vec.similar_ranks(st, f, "cpu", device_threshold=0))
    assert METRICS.get("knn_route_total", route="host") == host0
    memgov.set_alloc_fault(None)
    dev0 = METRICS.get("knn_route_total", route="device")
    assert vec.similar_ranks(st, f, "cpu",
                             device_threshold=0).tolist() == want
    assert METRICS.get("knn_route_total", route="device") == dev0 + 1


def _fused_knn_degrades_on_the_same_device(monkeypatch):
    """`test_vec.py::test_fused_knn_under_alloc_fault_serves_host_bit_
    identically` on the port: the program's failure degrades to the
    staged route on the same device, equal to the host walk; when the
    staged top-k fails too, the query raises."""
    st = _port_store(test_vec, "_vec_store", n=64, seed=9)
    q = ('{ q(func: similar_to(emb, 5, "[2, 0, 1, 3]")) '
         '@recurse(depth: 2) { uid friend } }')
    want = Engine(st, device="cpu", device_threshold=10**9).query(q)
    _inject("fused.")
    assert Engine(st, device="cpu", device_threshold=0).query(q) == want
    assert memgov.GOVERNOR.oom_stats()["degraded"] == 1
    memgov.GOVERNOR.reset()
    _inject("fused.", "hop.", "vec.")
    before = memgov.GOVERNOR.oom_stats()
    with pytest.raises(memgov.AllocFault):
        Engine(st, device="cpu", device_threshold=0).query(q)
    # the program's event and degrade, then the staged top-k's event
    after = memgov.GOVERNOR.oom_stats()
    assert after["events"] == before["events"] + 2
    assert after["degraded"] == 1


def _feat_fault_raises(monkeypatch):
    """`test_feat.py::test_persistent_feat_fault_degrades_to_host_and_
    sticks` on the port: the device combine's failed retry raises out of
    the query; the host combine serves nothing in its place, nothing
    sticks, and the device route binds the same features once the fault
    is gone."""
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    st = _port_store(test_feat, "_feat_store", n=48, seed=5)
    q = test_feat._QUERIES[1]
    want = json.dumps(Engine(st, device="cpu",
                             device_threshold=10**9).query(q))
    host0 = METRICS.get("feat_route_total", route="host")
    _inject("feat.agg")
    deg = Engine(st, device="cpu", device_threshold=0)
    _fails_without_host_route(lambda: deg.query(q))
    assert METRICS.get("feat_route_total", route="host") == host0
    memgov.set_alloc_fault(None)
    dev0 = METRICS.get("feat_route_total", route="device")
    assert json.dumps(deg.query(q)) == want
    assert METRICS.get("feat_route_total", route="device") > dev0


PORT_POLICY = {
    "test_degraded_route_is_bit_identical_to_device_route":
        _degrade_on_the_same_device,
    "test_persistent_alloc_fault_degrades_to_host_bit_identically":
        _vec_fault_raises,
    "test_fused_knn_under_alloc_fault_serves_host_bit_identically":
        _fused_knn_degrades_on_the_same_device,
    "test_persistent_feat_fault_degrades_to_host_and_sticks":
        _feat_fault_raises,
}


def test_alloc_fault_sites_count_one_event_each():
    """One injected allocation failure at each of the six launch sites
    the port governs raises the OOM counters by exactly one event, is
    absorbed by the retry, and leaves every answer equal — the CPU form
    of chip_smoke.py phase 13 (c)."""
    a = Alpha(device="cpu", device_threshold=0)
    a.alter("friend: [uid] @reverse .\nemb: float32vector @dim(4) .\n"
            "name: string @index(exact) .")
    rng = np.random.default_rng(3)
    lines = []
    for i in range(1, 41):
        e = ", ".join(str(int(x)) for x in rng.integers(0, 5, 4))
        lines.append(f'<{i}> <emb> "[{e}]" .')
        lines.append(f'<{i}> <name> "p{i}" .')
        for j in rng.integers(1, 41, 3):
            if i != int(j):
                lines.append(f"<{i}> <friend> <{int(j)}> .")
    a.mutate(set_nquads="\n".join(lines))
    batch = (["{ q(func: uid(%d)) @recurse(depth: 3) { friend } }" % i
              for i in range(1, 6)]
             + ['{ path as shortest(from: %d, to: %d) { friend } }'
                % (i, 40 - i) for i in range(1, 6)])
    per_query = ['{ q(func: uid(1, 2, 3)) { friend { friend { uid } } } }',
                 '{ q(func: uid(1, 2, 3)) { friend (orderasc: name) '
                 '{ uid } } }',
                 '{ q(func: similar_to(emb, 3, "[1, 0, 2, 1]")) { uid } }',
                 '{ q(func: uid(1, 2, 3)) @msgpass(pred: emb, agg: sum) '
                 '{ friend { uid } } }']
    want_batch = a.query_batch(batch)
    want = [a.query(q) for q in per_query]
    sites = ("bfs.ell_recurse", "bfs.ell_step", "fused.program",
             "hop.gather_edges", "vec.topk", "feat.agg")
    for site in sites:
        armed = [True]

        def hook(s, site=site, armed=armed):
            if armed[0] and s == site:
                armed[0] = False
                return True
            return False

        memgov.set_alloc_fault(hook)
        before = memgov.GOVERNOR.oom_stats()
        with pytest.MonkeyPatch.context() as m:
            if site in ("hop.gather_edges", "vec.topk", "feat.agg"):
                # the staged route's launches, not a program's stages
                m.setenv("DGRAPH_TPU_FUSED", "0")
            if site.startswith("bfs."):
                assert a.query_batch(batch) == want_batch
            else:
                assert [a.query(q) for q in per_query] == want
        memgov.set_alloc_fault(None)
        assert not armed[0], site
        after = memgov.GOVERNOR.oom_stats()
        assert after["events"] == before["events"] + 1, site
        assert after["degraded"] == 0, site
        assert METRICS.get("oom_events_total", site=site) >= 1
