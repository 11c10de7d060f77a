"""Port Engine == the JAX package's Engine on the DQL golden table.

The fixture store of tests/test_query.py is built through the reference
StoreBuilder and carried into the port with store_from_arrays. Every
golden case (aggregates, math, @groupby, @cascade, @normalize, regexp and
the rest) runs through the reference Engine and the port Engine on the
CPU at device_threshold 0 (every non-empty frontier through the torch
ops) and 10**9 (the host walk); the JSON must be equal. The error table
must raise the same exception type in both packages.
"""

import json

import pytest
import torch

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.store.store import store_from_arrays
from test_query import CASES, ERROR_CASES, build_store

CPU = "cpu"
torch.set_num_threads(1)
THRESHOLDS = [0, 10**9]


@pytest.fixture(scope="module")
def stores():
    ref = build_store()
    return ref, store_from_arrays(ref)


@pytest.fixture(scope="module")
def engines(stores):
    ref, port = stores
    return {t: (RefEngine(ref, device_threshold=t),
                Engine(port, device=CPU, device_threshold=t))
            for t in THRESHOLDS}


def _same(engines, thresh, query):
    ref_eng, port_eng = engines[thresh]
    want = ref_eng.query(query)
    got = port_eng.query(query)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    # key order is part of the response
    assert json.dumps(got) == json.dumps(want)
    return got


@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("name,query,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_golden_equals_reference(engines, thresh, name, query, expected):
    got = _same(engines, thresh, query)
    assert got == expected


@pytest.mark.parametrize("name,query", ERROR_CASES,
                         ids=[c[0] for c in ERROR_CASES])
def test_query_errors_raise_as_reference(stores, name, query):
    ref, port = stores
    with pytest.raises(Exception) as want:
        RefEngine(ref, device_threshold=10**9).query(query)
    with pytest.raises(Exception) as got:
        Engine(port, device=CPU, device_threshold=10**9).query(query)
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(got.value, ValueError) == isinstance(want.value,
                                                           ValueError)


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_child_groupby_is_per_parent(engines, thresh):
    out = _same(engines, thresh, """
      { p(func: uid(1, 2)) { name friend @groupby(alive) { count(uid) } } }""")
    michonne, lear = out["p"]
    assert michonne["friend"] == [{"@groupby": [
        {"alive": False, "count": 1}, {"alive": True, "count": 2}]}]
    assert lear["friend"] == [{"@groupby": [{"alive": True, "count": 1}]}]


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_nested_aggregate(engines, thresh):
    out = _same(engines, thresh, """
      { var(func: type(Person)) { a as age }
        q(func: uid(1)) { name friend { min(val(a)) cnt: count(uid) } } }""")
    assert out == {"q": [{"name": "Michonne",
                          "friend": [{"min(val(a))": 31}, {"cnt": 3}]}]}


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_math_unspaced_minus(engines, thresh):
    out = _same(engines, thresh, """
      { var(func: uid(1)) { a as age }
        q(func: uid(a)) { m: math(a-8) } }""")
    assert out["q"] == [{"m": 30}]


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_groupby_uid_predicate(engines, thresh):
    out = _same(engines, thresh, """
      { films(func: type(Film)) @groupby(genre) { count(uid) } }""")
    assert out == {"films": [{"@groupby": [
        {"genre": "0xc8", "count": 1}, {"genre": "0xc9", "count": 2}]}]}
