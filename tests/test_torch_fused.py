"""Port whole-block programs (engine/fused.py) == the JAX package's.

Stores are built through the reference StoreBuilder (tests/test_fused.py's
SNB-flavoured fixture) or the LDBC generators at sf=0.02 and carried into
the port. On the CPU the port runs each program's plain function (the
function a CUDA graph captures on the card):
  * fused ≡ staged ≡ the reference Engine's query_bytes, byte for byte,
    at device_threshold 0 and 10**9, over test_fused.py's 10 template
    shapes and the 14 LDBC IC templates plus config 3;
  * the port fuses exactly the blocks the reference fuses, with no
    fallback;
  * each stage emitter's outputs equal the reference's jitted program's,
    slot for slot, at the same caps;
  * the flag, ineligible shapes, the sticky fallback (CPU only: on the
    card a failing program raises), cap regrowth, the memoized filter
    sets, the program memo's bounds and its drop of a collected store's
    programs, and tree-batch rebuilds (which read their lane masks and
    launch no whole-block program);
  * the GraphRAG shapes (knn and featprop stages, over tests/test_feat.py's
    4-d small-integer friend graph): the same blocks fused as the
    reference's plan_block, bytes fused ≡ staged ≡ reference, and the
    knn / featprop programs slot for slot against the reference's.
Tolerance: exact everywhere (integer outputs, small-integer f32 sums and
JSON bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgraph_tpu.dql.parser import parse as ref_parse
from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.engine import fused as ref_fused
from dgraph_tpu.models import ldbc as ref_ldbc
from dgraph_tpu.ops import uidalgebra as ref_ua
from dgraph_tpu.server.api import Alpha
from dgraph_tpu.utils.metrics import METRICS
from dgraph_tpu_torch.dql.parser import parse
from dgraph_tpu_torch.engine import Engine, fused
from dgraph_tpu_torch.engine.execute import Executor, _bucket
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.store.store import StoreBuilder, store_from_arrays
from dgraph_tpu_torch.utils import memgov
from test_fused import IC_TEMPLATES
from test_fused import _store as ref_store_of
from test_torch_memgov import reset_cost_state

CPU = "cpu"
THRESHOLDS = [0, 10**9]
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    fused.reset()
    ref_fused.reset()
    reset_cost_state()
    yield
    fused.reset()
    ref_fused.reset()
    reset_cost_state()


@pytest.fixture(scope="module")
def stores():
    ref = ref_store_of()
    return ref, store_from_arrays(ref)


def _ref_fused_blocks(eng, q) -> tuple:
    """(the reference's query_bytes, the blocks its fused route took)."""
    before = METRICS.get("fused_route_total", route="fused")
    out = eng.query_bytes(q)
    return out, METRICS.get("fused_route_total", route="fused") - before


def _three_way(monkeypatch, ref_eng, port_eng, q) -> int:
    """Port fused ≡ port staged ≡ reference bytes; returns the blocks
    the port fused, checked against the reference's."""
    want, ref_blocks = _ref_fused_blocks(ref_eng, q)
    before = fused.status()["routes"]["fused"]
    got = port_eng.query_bytes(q)
    port_blocks = fused.status()["routes"]["fused"] - before
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    staged = port_eng.query_bytes(q)
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    assert got == want
    assert staged == want
    assert port_blocks == ref_blocks
    st = fused.status()
    assert st["fallbacks"] == 0 and st["routes"]["fallback"] == 0
    assert not st["disabled"]
    return port_blocks


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("i", range(len(IC_TEMPLATES)))
def test_template_shapes_fused_equal_staged_and_reference(
        stores, monkeypatch, threshold, i):
    ref, port = stores
    n = _three_way(monkeypatch, RefEngine(ref, device_threshold=threshold),
                   Engine(port, device=CPU, device_threshold=threshold),
                   IC_TEMPLATES[i])
    # every template shape of the reference's fused tests fuses its
    # first block
    assert n >= 1


# -- the LDBC IC mix at sf 0.02 ---------------------------------------------------

@pytest.fixture(scope="module")
def snb():
    g = ref_ldbc.generate(sf=0.02)
    a = Alpha(device_threshold=10**9)
    ref_ldbc.load_into(a, g)
    view = a.mvcc.read_view(a.oracle.read_only_ts())
    pg = ldbc.generate(sf=0.02)
    b = StoreBuilder()
    ldbc.load_into(b, pg)
    qs = dict(ldbc.ic_templates(pg))
    qs["config3"] = ldbc.config3_query(pg)
    return view, b.finalize(), qs


LDBC_NAMES = [f"IC{i}" for i in range(1, 15)] + ["config3"]
# the blocks the reference's plan_block fuses (one IC mix pass: IC1's
# first block, IC3/4/6/7/10/11/12, both blocks of IC9; and config 3)
LDBC_FUSED = {"IC1": 1, "IC3": 1, "IC4": 1, "IC6": 1, "IC7": 1, "IC9": 2,
              "IC10": 1, "IC11": 1, "IC12": 1, "config3": 1}


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("name", LDBC_NAMES)
def test_ldbc_fused_equal_staged_and_reference(snb, monkeypatch, name,
                                               threshold):
    view, port, qs = snb
    q = qs[name]
    n = _three_way(monkeypatch, RefEngine(view, device_threshold=threshold),
                   Engine(port, device=CPU, device_threshold=threshold), q)
    assert n == LDBC_FUSED.get(name, 0)
    assert n == sum(ref_fused.plan_block(view, sg) is not None
                    for sg in ref_parse(q))


# -- the program against the reference's, slot for slot -------------------------

def _inputs(port, plan, sg):
    """Host inputs of one program call, as `_run_plan` makes them."""
    ex = Executor(port, device=CPU)
    rels, alloweds, pages = [], [], []
    for st, ssg in zip(plan.stages, plan.stage_sgs):
        rels.append(port.rel(st.attr, st.reverse))
        alloweds.append(ex.filter_set(ssg.filters) if st.has_filter
                        else np.zeros(0, np.int32))
        first = (ssg.first if st.kind == "hop" and ssg.first
                 else fused.NO_LIMIT)
        pages.append((ssg.offset if st.kind == "hop" else 0, first))
    nodes = np.unique(ex.root_display(sg)).astype(np.int32)
    return rels, alloweds, pages, nodes


def _same(want, got):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(want) == len(got)
        for w, g in zip(want, got):
            _same(w, g)
        return
    w, g = np.asarray(want), got.numpy()
    assert w.shape == g.shape and np.array_equal(w, g), (w, g)


@pytest.mark.parametrize("i", range(len(IC_TEMPLATES)))
def test_program_equals_reference_slot_for_slot(stores, i):
    ref, port = stores
    q = IC_TEMPLATES[i]
    sg, rsg = parse(q)[0], ref_parse(q)[0]
    plan, rplan = fused.plan_block(port, sg), ref_fused.plan_block(ref, rsg)
    assert [s.kind for s in plan.stages] == [s.kind for s in rplan.stages]
    rels, alloweds, pages, nodes = _inputs(port, plan, sg)
    caps = fused._estimate_caps(plan, rels, nodes)
    f_cap = caps[0][1] if plan.recurse else _bucket(max(len(nodes), 1))
    flat, layout = fused._pack(nodes, f_cap, alloweds, pages)
    program = fused._build_program(tuple(plan.stages), caps, layout)
    outs, sizes = program(
        tuple((torch.from_numpy(r.indptr), torch.from_numpy(r.indices))
              for r in rels), torch.from_numpy(flat))
    want = ref_fused._build_program(tuple(rplan.stages), caps)(
        tuple((jnp.asarray(r.indptr), jnp.asarray(r.indices))
              for r in rels),
        ref_ua.pad_to(nodes, f_cap),
        tuple(ref_ua.pad_to(a, _bucket(max(len(a), 1))) for a in alloweds),
        tuple((np.int32(o), np.int32(f)) for o, f in pages))
    _same(tuple(want), outs)
    # the packed sizes are the scalar outputs, stage by stage
    split = fused._split_sizes(plan, sizes.numpy())
    for st, out, sz in zip(plan.stages, outs, split):
        if st.kind == "hop":
            assert [int(out[3]), int(out[5]), int(out[6])] == sz.tolist()
        elif st.kind == "recurse":
            assert np.array_equal(torch.stack([out[2], out[5], out[4]]), sz)


# -- the route's rules -------------------------------------------------------------

Q_HOP = '{ q(func: uid(0x2)) { knows { uid } } }'


def test_flag_off_pins_staged_route(stores, monkeypatch):
    _ref, port = stores
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    eng = Engine(port, device=CPU)
    eng.query(Q_HOP)
    st = fused.status()
    assert not st["enabled"]
    assert st["routes"] == {"fused": 0, "staged": 0, "fallback": 0}
    assert eng.routes.expansions["program"] == 0


def test_ineligible_shapes_route_staged(stores):
    """Ordering, complement filters and var-dependent filters stay
    staged, counted as such; answers equal the reference's."""
    ref, port = stores
    eng = Engine(port, device=CPU, device_threshold=10**9)
    ref_eng = RefEngine(ref, device_threshold=10**9)
    qs = ['{ q(func: uid(0x2)) { knows (orderasc: name) { name } } }',
          '{ q(func: uid(0x2)) { knows @filter(NOT eq(city, "c1")) '
          '{ uid } } }',
          '{ v as q(func: uid(0x2)) { knows @filter(uid(v)) { uid } } }']
    for q in qs:
        assert eng.query_bytes(q) == ref_eng.query_bytes(q)
    st = fused.status()
    assert st["routes"] == {"fused": 0, "staged": 3, "fallback": 0}
    assert eng.routes.expansions["program"] == 0


def test_sticky_fallback_lifecycle(stores, monkeypatch, caplog):
    """On the CPU a failing program sends its shape to the staged route
    for good: logged, counted, answers unchanged; reset() re-arms it."""
    _ref, port = stores
    eng = Engine(port, device=CPU)
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    want = eng.query_bytes(Q_HOP)
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")

    def boom(*a, **k):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(fused, "_build_program", boom)
    assert eng.query_bytes(Q_HOP) == want
    st = fused.status()
    assert st["fallbacks"] == 1 and st["routes"]["fallback"] == 1
    assert len(st["disabled"]) == 1
    assert "staged route serves this shape" in caplog.text
    # sticky: no second attempt (boom would count again)
    assert eng.query_bytes(Q_HOP) == want
    st = fused.status()
    assert st["fallbacks"] == 1 and st["routes"]["fallback"] == 2
    monkeypatch.undo()
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    fused.reset()
    assert eng.query_bytes(Q_HOP) == want
    st = fused.status()
    assert st["routes"] == {"fused": 1, "staged": 0, "fallback": 0}
    assert not st["disabled"]


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("operation not permitted when stream is capturing")])
def test_failing_program_raises_on_the_card(stores, monkeypatch, err):
    """On a CUDA executor a failing program raises: no shape is pinned
    to the staged route and no fallback is counted (no card needed: the
    program call itself is replaced). The one exception is an allocation
    failure (`torch.OutOfMemoryError`): the memory governor evicts and
    runs the call once more, and when that fails too the shape is
    degraded to the staged route on the same card, counted as one OOM
    event, one degraded shape and one fallback — never pinned by the
    program memo itself."""
    from types import SimpleNamespace

    _ref, port = stores
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise err

    monkeypatch.setattr(fused, "_run_plan", boom)
    ex = SimpleNamespace(store=port, device=torch.device("cuda"))
    st0 = memgov.GOVERNOR.oom_stats()
    if memgov.is_alloc_failure(err):
        assert fused.try_fused(ex, parse(Q_HOP)[0]) is None
        assert len(calls) == 2
        st = fused.status()
        assert st["fallbacks"] == 1 and not st["disabled"]
        assert st["routes"] == {"fused": 0, "staged": 0, "fallback": 1}
        assert memgov.GOVERNOR.oom_stats() == {
            "events": st0["events"] + 1, "retries": st0["retries"] + 1,
            "degraded": st0["degraded"] + 1}
        # degraded: the next call goes to the staged route at once
        assert fused.try_fused(ex, parse(Q_HOP)[0]) is None
        assert len(calls) == 2
        return
    with pytest.raises(type(err)):
        fused.try_fused(ex, parse(Q_HOP)[0])
    assert len(calls) == 1
    st = fused.status()
    assert st["fallbacks"] == 0 and not st["disabled"]
    assert st["routes"] == {"fused": 0, "staged": 0, "fallback": 0}
    assert memgov.GOVERNOR.oom_stats() == st0


@pytest.mark.parametrize("filt,memo", [
    ('eq(city, "c1")', True),
    ('has(likes)', True),
    ('eq(city, "c1") OR eq(city, "c3")', True),
    ('eq(city, "c1") AND has(name)', True),
    ('uid(v)', False),            # reads a variable: evaluated per call
])
def test_filter_sets_memoized_per_store(stores, monkeypatch, filt, memo):
    """A filter tree that reads no variable is evaluated once per store
    and shared by later calls (fused and staged); one that reads a
    variable is evaluated per call. Answers equal the reference's."""
    from dgraph_tpu_torch.engine import execute

    ref, _port = stores
    port = store_from_arrays(ref)        # a store no other test touched
    q = ('{ v as var(func: uid(0x3, 0x5)) { uid } '
         '  q(func: uid(0x2, 0x4)) { knows @filter(%s) { uid } } }' % filt)
    want = RefEngine(ref, device_threshold=10**9).query_bytes(q)
    calls = []
    real = execute.Executor._filter_set

    def counted(self, tree):
        calls.append(tree.op)
        return real(self, tree)

    monkeypatch.setattr(execute.Executor, "_filter_set", counted)
    for thr in (0, 10**9, 0):
        assert Engine(port, device=CPU,
                      device_threshold=thr).query_bytes(q) == want
    first = len(calls)
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    assert Engine(port, device=CPU, device_threshold=0).query_bytes(q) == want
    if memo:
        assert len(port._filter_sets) == 1 and len(calls) == first
    else:
        assert not port._filter_sets and len(calls) > first


def test_programs_of_a_collected_store_are_dropped(stores):
    """Programs hold their store's CSR tensors: once the store is
    collected, the next call drops them."""
    import gc

    ref, port = stores
    other = store_from_arrays(ref)
    assert Engine(other, device=CPU).query_bytes(Q_HOP) == \
        Engine(port, device=CPU).query_bytes(Q_HOP)
    assert fused.status()["programs"] == 2
    del other
    gc.collect()
    Engine(port, device=CPU).query_bytes(Q_HOP)
    st = fused.status()
    assert st["programs"] == 1 and st["evictions"] == 1
    assert {k[0] for k in fused._programs} == {id(port)}


def test_program_memo_bounded_by_count_and_graph_bytes(stores, monkeypatch):
    """The memo keeps at most PROGRAM_CAPACITY programs and
    PROGRAM_BYTES of graph memory, dropping the least recently used
    (the newest always stays)."""
    _ref, port = stores
    monkeypatch.setattr(fused, "PROGRAM_CAPACITY", 2)
    eng = Engine(port, device=CPU)
    qs = [IC_TEMPLATES[i] for i in (1, 2, 3, 4)]
    want = [RefEngine(_ref, device_threshold=10**9).query_bytes(q)
            for q in qs]
    assert [eng.query_bytes(q) for q in qs] == want
    st = fused.status()
    assert st["programs"] == 2 and st["evictions"] == 2
    # graph bytes (a capture's memory_reserved growth on the card)
    monkeypatch.setattr(fused, "PROGRAM_BYTES", 100)
    with fused._lock:
        for prog in fused._programs.values():
            prog.graph_bytes = 60
        fused._stats["program_bytes"] = 120
        fused._evict()
    st = fused.status()
    assert st["programs"] == 1 and st["program_bytes"] == 60
    assert eng.query_bytes(qs[3]) == want[3]
    assert fused.status()["hits"] == 1


@pytest.mark.parametrize("q", [
    '{ q(func: eq(city, "c1")) { uid knows { uid knows { uid } } } }',
    '{ q(func: eq(city, "c1")) @recurse(depth: 3) { uid knows } }',
])
def test_caps_regrow_on_overflow(stores, monkeypatch, q):
    """Caps far too small at first: the program overflows, the caps
    regrow (a new program each time) until they hold, and the memoized
    caps serve the next call at once."""
    ref, port = stores
    want = RefEngine(ref, device_threshold=10**9).query_bytes(q)
    monkeypatch.setattr(fused, "_estimate_caps", lambda plan, rels, nodes:
                        tuple((64, 64) if s.kind == "recurse" else (64,)
                              for s in plan.stages))
    eng = Engine(port, device=CPU)
    assert eng.query_bytes(q) == want
    st = fused.status()
    assert st["misses"] >= 2 and st["hits"] == 0
    assert st["routes"]["fused"] == 1
    (caps,) = fused._caps_memo.values()
    assert max(c[0] for c in caps) > 64
    assert eng.query_bytes(q) == want
    assert fused.status()["hits"] == 1


def test_tree_batch_rebuild_runs_no_program(snb):
    """The tree groups' host rebuild reads the run's lane masks and never
    enters a whole-block program (the reference re-runs each block as
    one); the answers equal the per-query engine's."""
    from dgraph_tpu_torch.engine import batch
    from dgraph_tpu_torch.engine.treebatch import TreePlan

    _view, port, _qs = snb
    pairs = [(nm, q) for nm, q in ldbc.ic_batch(ldbc.generate(sf=0.02),
                                                copies=4, seed=5)
             if nm in ("IC3", "IC9", "IC12", "config3")]
    qs = [q for _nm, q in pairs]
    plans, left = batch.plan_batch_groups_cached(port, qs)
    assert not left and all(isinstance(p, TreePlan) for p, _i in plans)
    got = batch.query_batch(port, qs, device=CPU)
    st = fused.status()
    assert st["routes"] == {"fused": 0, "staged": 0, "fallback": 0}
    assert st["misses"] == 0
    eng = Engine(port, device=CPU)
    assert [eng.query(q) for q in qs] == got
    # and the per-query engine did fuse these blocks
    assert fused.status()["routes"]["fused"] == len(qs) + 4


@pytest.mark.cuda
def test_captured_replay_equals_eager_run(stores):
    """On the card: each captured program's replay equals an eager run
    of its plain function on the same inputs, and answers equal the
    CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU has no CUDA graphs)")
    _ref, port = stores
    cpu = Engine(port, device=CPU)
    card = Engine(port, device="cuda")
    for q in IC_TEMPLATES:
        assert card.query_bytes(q) == cpu.query_bytes(q)
    progs = fused.captured()
    assert progs and fused.status()["captures"] == len(progs)
    for p in progs:
        p.graph.replay()
        got = [t.clone() for out in p.static_out[0] for t in out]
        want = [t for out in p.fn(p.rels, p.static_in)[0] for t in out]
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- GraphRAG shapes: knn and featprop stages ----------------------------------

# similar_to seeds and @msgpass over tests/test_feat.py's 4-d
# small-integer friend graph: knn → hop, knn → recurse, recurse →
# featprop for each agg, knn → recurse → featprop, and the shapes that
# stay staged (a filtered similar_to root, plain-level @msgpass)
VEC_TEMPLATES = [
    '{ q(func: similar_to(emb, 4, "[1, 1, 2, 0]")) '
    '{ uid name friend { uid } } }',
    '{ q(func: similar_to(emb, 3, 5)) { friend { c as count(friend) } } }',
    '{ q(func: similar_to(emb, 5, "[2, 0, 1, 3]")) '
    '@recurse(depth: 3) { uid friend } }',
    '{ q(func: uid(2, 9)) @recurse(depth: 3) '
    '@msgpass(pred: emb, agg: sum) { uid friend } }',
    '{ q(func: uid(2)) @recurse(depth: 2) '
    '@msgpass(pred: emb, agg: mean) { uid ~friend } }',
    '{ q(func: uid(4)) @recurse(depth: 3) '
    '@msgpass(pred: emb, agg: max) { uid friend } }',
    '{ q(func: similar_to(emb, 6, "[0, 2, 1, 1]")) @recurse(depth: 2) '
    '@msgpass(pred: emb, agg: mean) { uid friend } }',
    '{ q(func: similar_to(emb, 4, "[1, 1, 2, 0]")) '
    '@filter(eq(name, "p3")) { uid friend { uid } } }',
    '{ q(func: uid(1, 2, 3)) @msgpass(pred: emb, agg: sum) '
    '{ uid friend { uid } } }',
]


@pytest.fixture(scope="module")
def vec_stores():
    from test_feat import _feat_store

    ref = _feat_store(n=64, seed=9)
    return ref, store_from_arrays(ref)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("i", range(len(VEC_TEMPLATES)))
def test_graphrag_shapes_fused_equal_staged_and_reference(
        vec_stores, monkeypatch, threshold, i):
    ref, port = vec_stores
    q = VEC_TEMPLATES[i]
    n = _three_way(monkeypatch, RefEngine(ref, device_threshold=threshold),
                   Engine(port, device=CPU, device_threshold=threshold), q)
    kinds = [[s.kind for s in p.stages] if p else None
             for p in (fused.plan_block(port, sg) for sg in parse(q))]
    ref_kinds = [[s.kind for s in p.stages] if p else None
                 for p in (ref_fused.plan_block(ref, sg)
                           for sg in ref_parse(q))]
    assert kinds == ref_kinds
    assert n == sum(k is not None for k in kinds)


@pytest.mark.parametrize("i", [0, 1, 2, 6])
def test_vec_program_equals_reference_slot_for_slot(vec_stores, i):
    """knn → hop, knn → hop → count, knn → recurse and knn → recurse →
    featprop programs against the reference's jitted program at the same
    caps: the seed set, every hop and recurse slot, and the featprop
    aggregates bit for bit."""
    from dgraph_tpu_torch.store import vec as port_vec

    ref, port = vec_stores
    q = VEC_TEMPLATES[i]
    sg, rsg = parse(q)[0], ref_parse(q)[0]
    plan, rplan = fused.plan_block(port, sg), ref_fused.plan_block(ref, rsg)
    assert [s.kind for s in plan.stages] == [s.kind for s in rplan.stages]
    qv = port_vec.resolve_query(port, sg.func)[2]
    ex = Executor(port, device=CPU)
    rels, devs, rdevs, alloweds, ralloweds, pages = [], [], [], [], [], []
    for st, ssg in zip(plan.stages, plan.stage_sgs):
        if st.kind in ("knn", "featprop"):
            t = port.vec_tablet(st.attr)
            rels.append(t)
            devs.append(port.vec_device(st.attr, CPU))
            rdevs.append((jnp.asarray(t.subj), jnp.asarray(t.vecs)))
            a = qv if st.kind == "knn" else np.zeros(0, np.int32)
            alloweds.append(a.view(np.int32))
            ralloweds.append(a if st.kind == "knn"
                             else ref_ua.pad_to(a, _bucket(1)))
        else:
            r = port.rel(st.attr, st.reverse)
            rels.append(r)
            devs.append((torch.from_numpy(r.indptr),
                         torch.from_numpy(r.indices)))
            rdevs.append((jnp.asarray(r.indptr), jnp.asarray(r.indices)))
            a = (ex.filter_set(ssg.filters) if st.has_filter
                 else np.zeros(0, np.int32))
            alloweds.append(a)
            ralloweds.append(ref_ua.pad_to(a, _bucket(max(len(a), 1))))
        pages.append((0, fused.NO_LIMIT))
    nodes = np.zeros(0, np.int32)
    caps = fused._estimate_caps(plan, rels, nodes)
    flat, layout = fused._pack(nodes, _bucket(1), alloweds, pages)
    outs, _sizes = fused._build_program(tuple(plan.stages), caps, layout)(
        tuple(devs), torch.from_numpy(flat))
    want = ref_fused._build_program(tuple(rplan.stages), caps)(
        tuple(rdevs), ref_ua.pad_to(nodes, 1), tuple(ralloweds),
        tuple((np.int32(o), np.int32(f)) for o, f in pages))
    for st, w, g in zip(plan.stages, want, outs):
        if st.kind == "knn":
            # the reference also returns k as a second slot
            _same(w[0], g[0])
            assert int(w[1]) == min(st.k, rels[0].rows)
        else:
            _same(tuple(w), g)
