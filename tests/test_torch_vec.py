"""Port float32vector tablets and `similar_to` == the JAX package's.

After tests/test_vec.py: stores are built through the reference
StoreBuilder (its 4-d small-integer fixture) and carried into the port
with store_from_arrays, or built through both packages' builders. The
port runs with device="cpu" (the device route is then its plain torch
ops). Held exactly: rank sets, tablet bytes, and JSON bytes against the
reference Engine, on the host route, the device route and whole-block
programs. Scores of small-integer vectors are exact, so every route's
order is the same; the keyed top-k (store/vec.device_topk) is also held
against the reference's jitted `_topk_kernel` on inputs with many ties
and a -0.0 score.
"""

import json
import types

import numpy as np
import pytest
import torch

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.engine import fused as ref_fused
from dgraph_tpu.store import vec as ref_vec
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu.utils.metrics import METRICS
from dgraph_tpu_torch.engine import Engine, fused
from dgraph_tpu_torch.store import vec
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder, store_from_arrays

CPU = "cpu"
DIM = 4
torch.set_num_threads(1)
SCHEMA = ("emb: float32vector @dim(%d) .\n"
          "friend: [uid] @reverse .\n"
          "name: string @index(exact) ." % DIM)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    fused.reset()
    ref_fused.reset()
    vec.reset()
    yield
    fused.reset()
    ref_fused.reset()


def _fill(b, n=24, seed=3):
    """tests/test_vec.py's `_vec_store` fixture into builder `b`."""
    rng = np.random.default_rng(seed)
    for i in range(1, n + 1):
        b.add_value(i, "emb", [int(x) for x in rng.integers(0, 5, DIM)])
        b.add_value(i, "name", f"p{i % 7}")
        for j in rng.integers(1, n + 1, 3):
            if i != int(j):
                b.add_edge(i, "friend", int(j))
    return b.finalize()


def _stores(n=24, seed=3):
    ref = _fill(RefBuilder(ref_parse_schema(SCHEMA)), n, seed)
    return ref, store_from_arrays(ref)


def _func(k, arg, attr="emb"):
    return types.SimpleNamespace(name="similar_to", attr=attr, args=[k, arg])


# -- host reference semantics ---------------------------------------------------

def test_host_topk_matches_oracle_and_reference():
    rng = np.random.default_rng(11)
    subj = np.arange(40, dtype=np.int32)
    vecs = rng.integers(0, 4, (40, DIM)).astype(np.float32)
    q = np.array([2, 1, 0, 3], np.float32)
    scores = vecs @ q
    for k in (1, 5, 17, 40):
        want = sorted(r for _, r in sorted(zip(-scores, subj.tolist()))[:k])
        got = vec.host_topk(subj, vecs, q, k)
        assert got.tolist() == want
        assert got.dtype == np.int32
        assert got.tolist() == ref_vec.host_topk(subj, vecs, q, k).tolist()


def test_host_topk_tie_break_is_lowest_rank():
    subj = np.array([3, 7, 9, 12, 20], np.int32)
    vecs = np.ones((5, 2), np.float32)
    got = vec.host_topk(subj, vecs, np.array([1, 1], np.float32), 3)
    assert got.tolist() == [3, 7, 9]


def test_host_topk_edge_cases():
    subj = np.array([1, 2], np.int32)
    vecs = np.array([[1, 0], [0, 1]], np.float32)
    q = np.array([1, 0], np.float32)
    assert vec.host_topk(subj, vecs, q, 99).tolist() == [1, 2]
    assert vec.host_topk(subj, vecs, q, 0).tolist() == []
    assert vec.host_topk(np.zeros(0, np.int32),
                         np.zeros((0, 2), np.float32), q, 3).tolist() == []


@pytest.mark.parametrize("seed", range(6))
def test_device_topk_equals_reference_topk_kernel(seed):
    """The keyed selection against the reference's jitted lexsort top-k
    and the host route: few distinct scores (many ties), negative and
    zero scores, and a row scoring -0.0 beside rows scoring +0.0."""
    rng = np.random.default_rng(100 + seed)
    n, d = 200, 3
    subj = np.sort(rng.choice(5000, n, replace=False)).astype(np.int32)
    vecs = rng.integers(-2, 3, (n, d)).astype(np.float32)
    q = np.array([1, -1, 0], np.float32)
    # an exact -0.0 score: -1 * 0 + (-0.0)
    vecs[7] = [0.0, -0.0, 5.0]
    q_t = torch.from_numpy(q)
    assert np.signbit(vecs[7] @ q) or (vecs[7] @ q) == 0
    for k in (1, 7, 64, n, n + 5):
        want = np.asarray(ref_vec._topk_kernel(subj, vecs, q, min(k, n)))
        got = vec.device_topk(torch.from_numpy(subj), torch.from_numpy(vecs),
                              q_t, k).numpy()
        assert got.tolist() == want.tolist(), k
        assert got.tolist() == vec.host_topk(subj, vecs, q, k).tolist()


def test_topk_keys_order_negative_zero_and_nan_like_lexsort():
    scores = torch.tensor([0.0, -0.0, 1.5, -2.0, float("nan"), -0.0, 3.0])
    subj = torch.arange(7, dtype=torch.int32)
    order = torch.sort(vec.topk_keys(scores, subj)).indices.tolist()
    want = np.lexsort((subj.numpy(), -scores.numpy())).tolist()
    assert order == want


# -- load-time refusals ------------------------------------------------------------

def test_vector_dim_mismatch_refused_at_load_time():
    b = StoreBuilder(parse_schema("emb: float32vector @dim(4) ."))
    b.add_value(1, "emb", [1, 2, 3, 4])
    with pytest.raises(ValueError, match="does not match schema dim"):
        b.add_value(2, "emb", [1, 2, 3])


def test_first_vector_fixes_width_without_dim_directive():
    b = StoreBuilder(parse_schema("emb: float32vector ."))
    b.add_value(1, "emb", [1, 2])
    with pytest.raises(ValueError, match="does not match schema dim"):
        b.add_value(2, "emb", [1, 2, 3])


def test_vector_list_form_refused_in_schema():
    with pytest.raises(ValueError):
        parse_schema("emb: [float32vector] .")


def test_vector_value_parsing_matches_reference():
    from dgraph_tpu.store.types import parse_vector as ref_parse_vector
    from dgraph_tpu_torch.store.types import parse_vector

    for v in ("[1, 2.5, -3]", "[ ]", [1, 2], (0.5,), np.arange(3)):
        assert parse_vector(v).tobytes() == ref_parse_vector(v).tobytes()
    for bad in ("1, 2", "[1, x]", 3, np.zeros((2, 2))):
        with pytest.raises(ValueError):
            ref_parse_vector(bad)
        with pytest.raises(ValueError):
            parse_vector(bad)


def test_vector_rows_as_numpy_equal_reference_column():
    """numpy rows through the port's add_value give the reference's value
    column (exact (uid, vector) repeats dropped, distinct ones kept,
    sorted by rank) and the same tablet."""
    rng = np.random.default_rng(4)
    uids = np.array([5, 2, 9, 2, 7, 2], np.int64)
    rows = rng.integers(0, 5, (6, DIM)).astype(np.float32)
    rows[3] = rows[1]        # an exact (uid, vector) repeat is dropped
    ref = RefBuilder(ref_parse_schema(SCHEMA))
    port = StoreBuilder(parse_schema(SCHEMA))
    for u, r in zip(uids.tolist(), rows):
        ref.add_value(u, "emb", r.tolist())
        port.add_value(u, "emb", r)
    sr, sp = ref.finalize(), port.finalize()
    cr, cp = sr.value_col("emb"), sp.value_col("emb")
    assert cp.subj.tolist() == cr.subj.tolist() == [0, 0, 1, 2, 3]
    assert [v.tobytes() for v in cp.vals] == [v.tobytes() for v in cr.vals]
    assert sp.vec_tablet("emb").vecs.tobytes() == \
        sr.vec_tablet("emb").vecs.tobytes()


# -- query-time refusals and structural empties -------------------------------

def test_query_time_refusals():
    _ref, port = _stores()
    eng = Engine(port, device=CPU, device_threshold=10**9)
    with pytest.raises(vec.VecQueryError, match="must be positive"):
        eng.query('{ q(func: similar_to(emb, 0, "[1, 1, 1, 1]")) { uid } }')
    with pytest.raises(ValueError, match="dim"):
        eng.query('{ q(func: similar_to(emb, 3, "[1, 1]")) { uid } }')


def test_empty_predicate_and_unknown_uid_serve_empty():
    _ref, port = _stores()
    eng = Engine(port, device=CPU, device_threshold=10**9)
    b = StoreBuilder(parse_schema("emb: float32vector @dim(2) .\n"
                                  "name: string ."))
    b.add_value(1, "name", "x")
    empty = Engine(b.finalize(), device=CPU, device_threshold=10**9)
    assert empty.query(
        '{ q(func: similar_to(emb, 3, "[1, 0]")) { uid } }') == {"q": []}
    assert eng.query(
        '{ q(func: similar_to(emb, 3, 0x7fff)) { uid } }') == {"q": []}


# -- route identity: host ≡ device ≡ uid form ------------------------------------

def test_device_route_equals_host_and_reference():
    ref, port = _stores(n=48)
    t = port.vec_tablet("emb")
    q = np.array([1, 3, 0, 2], np.float32)
    want = vec.host_topk(t.subj, t.vecs, q, 7)
    got = vec.similar_ranks(port, _func(7, q.tolist()), CPU,
                            device_threshold=0)
    assert got.tolist() == want.tolist()
    assert got.tolist() == ref_vec.similar_ranks(
        ref, _func(7, q.tolist()), device_threshold=0).tolist()
    host = vec.similar_ranks(port, _func(7, q.tolist()), CPU,
                             device_threshold=10**9)
    assert host.tolist() == want.tolist()
    assert vec.status()["routes"] == {"host": 1, "device": 1, "fused": 0}


def test_uid_form_uses_stored_vector_as_query():
    _ref, port = _stores()
    t = port.vec_tablet("emb")
    rank = int(port.rank_of(np.array([5], np.int64))[0])
    qv = t.vector_of(rank)
    by_uid = vec.similar_ranks(port, _func(4, 5), CPU,
                               device_threshold=10**9)
    assert by_uid.tolist() == vec.host_topk(t.subj, t.vecs, qv, 4).tolist()
    assert rank in by_uid


def test_vec_device_places_tablet_once():
    _ref, port = _stores()
    a = port.vec_device("emb", CPU)
    assert port.vec_device("emb", CPU) is a
    t = port.vec_tablet("emb")
    assert a[0].numpy().tolist() == t.subj.tolist()
    assert a[1].numpy().tobytes() == t.vecs.tobytes()


# -- whole-block programs: fused ≡ staged ≡ reference ------------------------------

KNN_QUERIES = [
    '{ q(func: similar_to(emb, 5, "[2, 0, 1, 3]")) '
    '@recurse(depth: 3) { uid friend } }',
    '{ q(func: similar_to(emb, 4, "[1, 1, 2, 0]")) '
    '{ uid name friend { uid } } }',
    '{ q(func: similar_to(emb, 6, "[0, 2, 1, 1]")) '
    '{ friend @filter(eq(name, "p3")) { name } } }',
    '{ q(func: similar_to(emb, 3, 7)) '
    '{ c as count(friend) } m() { max(val(c)) } }',
]


@pytest.mark.parametrize("threshold", [0, 10**9])
@pytest.mark.parametrize("i", range(len(KNN_QUERIES)))
def test_fused_knn_equals_staged_and_reference(monkeypatch, threshold, i):
    ref, port = _stores(n=64, seed=9)
    q = KNN_QUERIES[i]
    ref_eng = RefEngine(ref, device_threshold=threshold)
    before = METRICS.get("fused_route_total", route="fused")
    want = ref_eng.query_bytes(q)
    ref_blocks = METRICS.get("fused_route_total", route="fused") - before
    eng = Engine(port, device=CPU, device_threshold=threshold)
    got = eng.query_bytes(q)
    st = fused.status()
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    staged = eng.query_bytes(q)
    assert got == want
    assert staged == want
    assert st["routes"]["fused"] == ref_blocks >= 1
    assert st["fallbacks"] == 0 and not st["disabled"]
    assert vec.status()["routes"]["fused"] == 1


def test_query_json_renders_vector_values():
    ref, port = _stores(n=6)
    q = "{ q(func: uid(0x1)) { uid emb } }"
    out = Engine(port, device=CPU, device_threshold=10**9).query(q)
    v = out["q"][0]["emb"]
    assert isinstance(v, list) and len(v) == DIM
    assert all(isinstance(x, float) for x in v)
    assert Engine(port, device=CPU).query_bytes(q) == \
        RefEngine(ref, device_threshold=10**9).query_bytes(q)


def test_store_from_arrays_carries_vectors():
    """A reference store with an `emb` predicate, carried across: the
    same value column rows (copies, not shared), tablet arrays and
    answers."""
    ref, port = _stores(n=30, seed=5)
    rc, pc = ref.value_col("emb"), port.value_col("emb")
    assert pc.vals.dtype == object
    assert all(a.tobytes() == b.tobytes() and a is not b
               for a, b in zip(rc.vals, pc.vals))
    t0, t1 = ref.vec_tablet("emb"), port.vec_tablet("emb")
    assert t0.subj.tolist() == t1.subj.tolist()
    assert t0.vecs.tobytes() == t1.vecs.tobytes()
    assert port.schema.peek("emb").vector_dim == DIM
    q = ('{ q(func: similar_to(emb, 5, "[1, 2, 0, 2]")) '
         '{ uid friend { uid } } }')
    want = json.dumps(RefEngine(ref, device_threshold=10**9).query(q),
                      separators=(",", ":")).encode()
    assert Engine(port, device=CPU, device_threshold=10**9).query_bytes(q) \
        == want
