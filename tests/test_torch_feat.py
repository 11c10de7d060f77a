"""Port `@msgpass` feature traversal and the segment combine == the JAX
package's.

After tests/test_feat.py: its edge-set fixtures (powerlaw duplicates, a
star hub, a chain, a degree gap with an empty segment and a segment whose
neighbours have no row) and its 4-d small-integer friend graph, built
through the reference StoreBuilder and carried into the port. The port
runs with device="cpu", where `ops/feat.segment_combine` is its plain
torch version (the CUDA kernel runs only on the card: chip_smoke.py
phase 10 holds it against this plain version and against host_combine).
Held exactly: f32 arrays bit for bit (sums of small integers are exact
in any order), counts, and JSON bytes against the reference Engine on
the host route, the device route and whole-block programs; and a
query_batch with @msgpass queries against the per-query Engine.
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.engine import feat as ref_efeat
from dgraph_tpu.engine import fused as ref_fused
from dgraph_tpu.ops import feat as ref_ofeat
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu.utils.metrics import METRICS
from dgraph_tpu_torch.dql.parser import ParseError, parse
from dgraph_tpu_torch.engine import Engine, batch, fused
from dgraph_tpu_torch.engine import feat as efeat
from dgraph_tpu_torch.ops import feat as ofeat
from dgraph_tpu_torch.store import vec
from dgraph_tpu_torch.store.store import store_from_arrays
from test_feat import _graphs, _oracle

CPU = "cpu"
DIM = 4
AGGS = ("sum", "mean", "max")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    fused.reset()
    ref_fused.reset()
    efeat.reset()
    yield
    fused.reset()
    ref_fused.reset()


def _feat_stores(n=24, seed=3, skip_emb=()):
    """tests/test_feat.py's `_feat_store`, reference and carried port."""
    rng = np.random.default_rng(seed)
    b = RefBuilder(ref_parse_schema(
        "emb: float32vector @dim(%d) .\n"
        "friend: [uid] @reverse .\n"
        "name: string @index(exact) ." % DIM))
    for i in range(1, n + 1):
        if i not in skip_emb:
            b.add_value(i, "emb", [int(x) for x in rng.integers(0, 5, DIM)])
        b.add_value(i, "name", f"p{i % 7}")
        for j in rng.integers(1, n + 1, 3):
            if i != int(j):
                b.add_edge(i, "friend", int(j))
    ref = b.finalize()
    return ref, store_from_arrays(ref)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the combine: plain torch ≡ the reference's jitted combine ≡ numpy ----------

@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("name", ["powerlaw", "star", "chain", "degree_gap"])
def test_segment_combine_plain_equals_reference(name, agg):
    subj, vecs, graphs = _graphs()
    nbrs, seg, n_seg = graphs[name]
    want = ref_ofeat.combine_edges(subj, vecs, nbrs, seg,
                                   np.int32(len(nbrs)), n_seg, agg)
    got = ofeat.segment_combine(*_t(subj, vecs, nbrs, seg), len(nbrs),
                                n_seg, agg)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes(), (name, agg)
    w_out, w_cnt, w_ecnt = _oracle(subj, vecs, nbrs, seg, n_seg, agg)
    assert got[0].numpy().tobytes() == w_out.tobytes()


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("d", [1, 3, 8])
def test_segment_combine_plain_equals_reference_random(d, agg, sort):
    """Random tablets and edges with a dead sentinel-padded tail and a
    live prefix as a 0-d tensor (the fused stage passes the kept count
    that way), sorted and unsorted seg."""
    rng = np.random.default_rng(d * 10 + AGGS.index(agg))
    subj = np.sort(rng.choice(400, 100, replace=False)).astype(np.int32)
    vecs = rng.integers(-3, 4, (100, d)).astype(np.float32)
    n, n_seg = 300, 40
    nbrs = rng.integers(0, 400, n).astype(np.int32)
    seg = rng.integers(0, n_seg - 5, n).astype(np.int32)
    if sort:
        seg = np.sort(seg)
    pad = np.iinfo(np.int32).max
    nb_p = np.concatenate([nbrs, np.full(20, pad, np.int32)])
    sg_p = np.concatenate([seg, np.zeros(20, np.int32)])
    want = ref_ofeat.combine_edges(subj, vecs, nb_p, sg_p, np.int32(n),
                                   n_seg, agg)
    got = ofeat.segment_combine(*_t(subj, vecs, nb_p, sg_p),
                                torch.tensor(n, dtype=torch.int32), n_seg,
                                agg, seg_sorted=sort)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    host = efeat.host_combine(subj, vecs, nbrs, seg, n_seg, agg)
    for g, h in zip(got, host):
        assert g.numpy().tobytes() == h.tobytes()


@pytest.mark.parametrize("agg", AGGS)
def test_host_combine_equals_reference(agg):
    subj, vecs, graphs = _graphs()
    rng = np.random.default_rng(5)
    fvecs = rng.standard_normal(vecs.shape).astype(np.float32)
    for name, (nbrs, seg, n_seg) in graphs.items():
        for v in (vecs, fvecs):
            want = ref_efeat.host_combine(subj, v, nbrs, seg, n_seg, agg)
            got = efeat.host_combine(subj, v, nbrs, seg, n_seg, agg)
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes(), (name, agg)


def test_empty_and_nonparticipating_segments_are_zero_not_nan():
    subj, vecs, graphs = _graphs()
    nbrs, seg, n_seg = graphs["degree_gap"]
    for agg in AGGS:
        out, cnt, ecnt = (t.numpy() for t in ofeat.segment_combine(
            *_t(subj, vecs, nbrs, seg), len(nbrs), n_seg, agg))
        assert cnt[2] == 0 and ecnt[2] == 0
        assert cnt[3] == 0 and ecnt[3] == 3
        assert out[2].tolist() == [0.0] * DIM
        assert out[3].tolist() == [0.0] * DIM
        assert np.isfinite(out).all()


def test_duplicate_edges_count_twice():
    subj = np.array([1, 2], np.int32)
    vecs = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
    nbrs = np.array([1, 1, 2], np.int32)
    seg = np.zeros(3, np.int32)
    out, cnt, _ = ofeat.segment_combine(*_t(subj, vecs, nbrs, seg), 3, 1,
                                        "sum")
    assert out[0].tolist() == [2.0, 1.0, 0.0, 0.0]
    assert int(cnt[0]) == 3
    out, _, _ = ofeat.segment_combine(*_t(subj, vecs, nbrs, seg), 3, 1,
                                      "mean")
    assert out[0].tolist() == [float(np.float32(2) / np.float32(3)),
                               float(np.float32(1) / np.float32(3)),
                               0.0, 0.0]


def test_segment_combine_refuses_bad_inputs():
    subj, vecs, nbrs, seg = _t(np.array([1, 2], np.int32),
                               np.ones((2, 3), np.float32),
                               np.array([1], np.int32),
                               np.array([0], np.int32))
    with pytest.raises(ValueError, match="nbrs"):
        ofeat.segment_combine(subj, vecs, nbrs.long(), seg, 1, 1, "sum")
    with pytest.raises(ValueError, match="agg"):
        ofeat.segment_combine(subj, vecs, nbrs, seg, 1, 1, "median")
    with pytest.raises(ValueError, match="vecs"):
        ofeat.segment_combine(subj, vecs[:1], nbrs, seg, 1, 1, "sum")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ofeat.segment_combine(subj.to("meta"), vecs.to("meta"),
                              nbrs.to("meta"), seg.to("meta"), 1, 1, "sum")


# -- parser and typed refusals --------------------------------------------------

def test_parser_accepts_msgpass_and_defaults_agg_to_mean():
    mp = parse('{ q(func: uid(1)) @msgpass(pred: emb) { uid friend } }')[0] \
        .msgpass
    assert mp is not None and mp.pred == "emb" and mp.agg == "mean"


@pytest.mark.parametrize("bad", [
    '{ q(func: uid(1)) @msgpass(pred: emb, agg: median) { uid } }',
    '{ q(func: uid(1)) @msgpass(agg: sum) { uid } }',
    '{ q(func: uid(1)) @msgpass(pred: emb, depth: 2) { uid } }',
])
def test_parser_rejects_malformed_msgpass(bad):
    with pytest.raises(ParseError):
        parse(bad)


@pytest.mark.parametrize("q,match", [
    ('{ q(func: uid(1)) @recurse(depth: 3, loop: true) '
     '@msgpass(pred: emb, agg: sum) { uid friend } }', "loop"),
    ('{ q(func: uid(1)) @msgpass(pred: name, agg: sum) '
     '{ uid friend } }', "float32vector"),
])
def test_msgpass_typed_refusals(q, match):
    ref, port = _feat_stores()
    with pytest.raises(ValueError, match=match):
        RefEngine(ref, device_threshold=10**9).query(q)
    with pytest.raises(ValueError, match=match):
        Engine(port, device=CPU, device_threshold=10**9).query(q)


# -- engine routes: staged host ≡ device ≡ reference ---------------------------------

QUERIES = [
    '{ q(func: uid(1, 2, 3)) @msgpass(pred: emb, agg: sum) '
    '{ uid friend { uid } } }',
    '{ q(func: uid(2)) @recurse(depth: 3) '
    '@msgpass(pred: emb, agg: mean) { uid friend } }',
    '{ q(func: similar_to(emb, 4, "[1, 1, 2, 0]")) '
    '@recurse(depth: 2) @msgpass(pred: emb, agg: max) { uid friend } }',
]


def test_staged_device_route_equals_host_and_reference(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    ref, port = _feat_stores(n=48, seed=5)
    host = Engine(port, device=CPU, device_threshold=10**9)
    dev = Engine(port, device=CPU, device_threshold=0)
    r = RefEngine(ref, device_threshold=10**9)
    for q in QUERIES:
        want = json.dumps(r.query(q))
        assert json.dumps(host.query(q)) == want, q
        assert json.dumps(dev.query(q)) == want, q
    st = efeat.status()
    assert st["routes"]["host"] >= 3 and st["routes"]["device"] >= 3
    assert st["feature_bytes"] > 0


def test_msgpass_renders_count_leaf_style_keys(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    _ref, port = _feat_stores(n=24)
    out = Engine(port, device=CPU, device_threshold=10**9).query(QUERIES[0])
    keyed = [o for o in out["q"] if "sum(emb)" in o]
    assert keyed, out
    for o in keyed:
        v = o["sum(emb)"]
        assert isinstance(v, list) and len(v) == DIM
        assert all(isinstance(x, float) for x in v)


def test_nodes_without_kept_edges_carry_no_feat_key(monkeypatch):
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder

    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    b = StoreBuilder(parse_schema(
        "emb: float32vector @dim(%d) .\nfriend: [uid] @reverse ." % DIM))
    for i in (1, 2, 3):
        b.add_value(i, "emb", [i, 0, 0, 0])
    b.add_edge(1, "friend", 2)
    out = Engine(b.finalize(), device=CPU, device_threshold=10**9).query(
        '{ q(func: uid(1, 3)) @msgpass(pred: emb, agg: sum) '
        '{ uid friend { uid } } }')
    by_uid = {o["uid"]: o for o in out["q"]}
    assert by_uid["0x1"]["sum(emb)"] == [2.0, 0.0, 0.0, 0.0]
    assert "sum(emb)" not in by_uid["0x3"]


# -- whole-block featprop ≡ staged ≡ reference --------------------------------------

@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("threshold", [0, 10**9])
def test_fused_featprop_equals_staged_and_reference(monkeypatch, agg,
                                                    threshold):
    ref, port = _feat_stores(n=64, seed=9)
    qs = [q.replace("agg: sum", f"agg: {agg}")
           .replace("agg: mean", f"agg: {agg}")
           .replace("agg: max", f"agg: {agg}") for q in QUERIES]
    r = RefEngine(ref, device_threshold=threshold)
    eng = Engine(port, device=CPU, device_threshold=threshold)
    for q in qs:
        before = METRICS.get("fused_route_total", route="fused")
        want = r.query_bytes(q)
        ref_blocks = METRICS.get("fused_route_total", route="fused") - before
        f0 = fused.status()["routes"]["fused"]
        got = eng.query_bytes(q)
        port_blocks = fused.status()["routes"]["fused"] - f0
        monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
        staged = eng.query_bytes(q)
        monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
        assert got == want == staged, q
        assert port_blocks == ref_blocks, q
    assert efeat.status()["routes"]["fused"] == 2
    st = fused.status()
    assert st["fallbacks"] == 0 and not st["disabled"]


def test_fused_featprop_program_segments_are_sorted():
    """The featprop stage skips the grouping sort: each hop's kept
    segments from the recurse stage are non-decreasing with the dead
    slots after them, checked on the program's own outputs."""
    from dgraph_tpu_torch.engine.fused import _pack
    from dgraph_tpu_torch.ops.level import NO_LIMIT

    _ref, port = _feat_stores(n=64, seed=9)
    Engine(port, device=CPU, device_threshold=0).query(QUERIES[1])
    (prog,) = [p for p in fused._programs.values()
               if [s.kind for s in p.stages] == ["recurse", "featprop"]]
    nodes = port.rank_of(np.array([2], np.int64)).astype(np.int32)
    x, layout = _pack(nodes, prog.layout[0], [np.zeros(0, np.int32)] * 2,
                      [(0, NO_LIMIT)] * 2)
    assert layout == prog.layout
    outs, _sizes = prog.fn(prog.rels, torch.from_numpy(x))
    _nbrs_h, seg_h, kept_h, *_ = outs[0]
    assert int(kept_h.sum()) > 0
    for h in range(seg_h.shape[0]):
        s = seg_h[h].numpy().astype(np.int64)
        assert (np.diff(s) >= 0).all()
        assert (s[int(kept_h[h]):] == np.iinfo(np.int32).max).all()


# -- similar_to structural empties and typed refusals, non-sticky -------------------

def test_similar_to_uid_without_embedding_row_serves_empty():
    ref, port = _feat_stores(n=24, skip_emb=(7,))
    dev = Engine(port, device=CPU, device_threshold=0)
    host = Engine(port, device=CPU, device_threshold=10**9)
    q = '{ q(func: similar_to(emb, 3, 7)) { uid friend { uid } } }'
    assert dev.query(q) == host.query(q) == {"q": []}
    assert not fused.status()["disabled"]
    good = '{ q(func: similar_to(emb, 3, 5)) { uid friend { uid } } }'
    assert dev.query(good) == RefEngine(ref, device_threshold=0).query(good)
    f0 = fused.status()["routes"]["fused"]
    dev.query(good)
    assert fused.status()["routes"]["fused"] == f0 + 1


def test_malformed_similar_to_raises_typed_error_without_sticky():
    _ref, port = _feat_stores(n=24)
    dev = Engine(port, device=CPU, device_threshold=0)
    good = '{ q(func: similar_to(emb, 3, 5)) { uid } }'
    dev.query(good)
    assert issubclass(vec.VecQueryError, ValueError)
    for bad in ['{ q(func: similar_to(emb, 0, 5)) { uid } }',
                '{ q(func: similar_to(emb, 3, "nonsense")) { uid } }',
                '{ q(func: similar_to(emb, 3, "[1, 2]")) { uid } }']:
        with pytest.raises(vec.VecQueryError):
            dev.query(bad)
    st = fused.status()
    assert not st["disabled"] and st["fallbacks"] == 0
    f0 = st["routes"]["fused"]
    dev.query(good)
    assert fused.status()["routes"]["fused"] == f0 + 1


# -- batches: @msgpass queries are served per query -------------------------------

def test_batch_serves_msgpass_queries_per_query():
    """query_batch of @msgpass recurse queries, uid-rooted and
    similar_to-rooted with mixed aggs, well past MIN_BATCH: no kernel
    group takes them (the reference's recurse group would drop their
    bindings), and every answer equals the per-query Engine's with its
    aggregate key present."""
    _ref, port = _feat_stores(n=64, seed=9)
    qs = []
    for i in range(1, 2 * batch.MIN_BATCH + 1):
        agg = AGGS[i % 3]
        qs.append('{ q(func: uid(%d)) @recurse(depth: 2, loop: false) '
                  '@msgpass(pred: emb, agg: %s) { uid friend } }' % (i, agg))
        qs.append('{ q(func: similar_to(emb, 3, %d)) @recurse(depth: 2, '
                  'loop: false) @msgpass(pred: emb, agg: %s) '
                  '{ uid friend } }' % (i, agg))
    plans, leftover = batch.plan_batch_groups_cached(port, qs)
    assert plans == [] and leftover == list(range(len(qs)))
    got = batch.query_batch(port, qs, device=CPU)
    eng = Engine(port, device=CPU)
    for q, r in zip(qs, got):
        assert json.dumps(r, sort_keys=True) == json.dumps(
            eng.query(q), sort_keys=True)
    assert sum("(emb)" in json.dumps(r) for r in got) >= len(qs) // 2


def test_probe_shape_is_served_per_query():
    """The smallest input that shows the reference's batch fault: the
    24-node friend graph and MIN_BATCH copies of one uid-rooted @msgpass
    recurse query. The port forms no group and keeps the binding."""
    _ref, port = _feat_stores()
    q = ('{ q(func: uid(1)) @recurse(depth: 2, loop: false) '
         '@msgpass(pred: emb, agg: sum) { uid friend } }')
    qs = [q] * batch.MIN_BATCH
    assert batch.plan_batch_groups_cached(port, qs)[0] == []
    got = batch.query_batch(port, qs, device=CPU)
    want = Engine(port, device=CPU).query(q)
    assert "sum(emb)" in json.dumps(want)
    assert all(r == want for r in got)


def test_fused_flag_read_per_query(monkeypatch):
    _ref, port = _feat_stores()
    eng = Engine(port, device=CPU)
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    eng.query(QUERIES[1])
    assert efeat.status()["routes"]["fused"] == 0
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    eng.query(QUERIES[1])
    assert efeat.status()["routes"]["fused"] == 1
