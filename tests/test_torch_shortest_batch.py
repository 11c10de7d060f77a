"""Port shortest-path lane groups == the JAX package's, exactly.

The scenarios of tests/test_batch.py:228-290 on its fixture (400 nodes,
name/score, follows @reverse), built through the reference Alpha and
carried into the port with store_from_arrays; the port runs with
device="cpu". Every group's port run_batch equals the reference's
run_batch and the port's per-query Engine; the mixed batch equals the
reference Alpha.query_batch. Tolerance: exact (JSON compared whole).
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.dql.parser import parse as ref_parse
from dgraph_tpu.engine import batch as ref_batch
from dgraph_tpu.server.api import Alpha
from dgraph_tpu_torch.dql.parser import parse as port_parse
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.engine import batch as port_batch
from dgraph_tpu_torch.store.store import store_from_arrays

CPU = "cpu"
HOST = 10**9
torch.set_num_threads(1)
SCHEMA = """
name: string @index(exact) .
score: int .
follows: [uid] @reverse .
"""


@pytest.fixture(scope="module")
def alpha():
    rng = np.random.default_rng(5)
    a = Alpha(device_threshold=HOST)
    a.alter(SCHEMA)
    n = 400
    lines = [f'_:p{i} <name> "p{i}" .\n_:p{i} <score> "{i % 23}"^^<xs:int> .'
             for i in range(n)]
    for i in range(n):
        for j in rng.choice(n, 4, replace=False):
            if i != j:
                lines.append(f"_:p{i} <follows> _:p{j} .")
    a.mutate(set_nquads="\n".join(lines))
    return a


@pytest.fixture(scope="module")
def stores(alpha):
    ref = alpha.mvcc.read_view(alpha.oracle.read_only_ts())
    return ref, store_from_arrays(ref)


def _uid(stores, name: str) -> str:
    ref, _port = stores
    return hex(int(ref.uids[ref.index_lookup("name", "exact", name)[0]]))


def _check_group(stores, qs, first_visit):
    """One shortest group in both packages; port == reference == port
    per-query Engine."""
    ref, port = stores
    r_plan = ref_batch.plan_batch(ref, [ref_parse(q) for q in qs])
    p_plan = port_batch.plan_batch(port, [port_parse(q) for q in qs])
    assert isinstance(p_plan, port_batch._ShortestPlan)
    assert isinstance(r_plan, ref_batch._ShortestPlan)
    assert p_plan.sig == r_plan.sig and p_plan.first_visit == first_visit
    want = ref_batch.run_batch(ref, r_plan, HOST)
    got = port_batch.run_batch(port, p_plan, CPU, HOST)
    assert json.dumps(got) == json.dumps(want)
    eng = Engine(port, device=CPU, device_threshold=HOST)
    assert json.dumps([eng.query(q) for q in qs]) == json.dumps(want)
    return got


def test_shortest_batch_ic13_shape(stores):
    """shortest + a uid(path) companion block forms one group."""
    pairs = [("p1", "p40"), ("p3", "p77"), ("p5", "p250"),
             ("p7", "p123"), ("p11", "p319"), ("p13", "p2")]
    qs = ['{ path as shortest(from: %s, to: %s) { follows } '
          'p(func: uid(path)) { name } }'
          % (_uid(stores, a), _uid(stores, b)) for a, b in pairs]
    got = _check_group(stores, qs, first_visit=True)
    assert any(o.get("p") for o in got)


def test_shortest_numpaths_level_dag(stores):
    """numpaths: 2 rides the level DAG (first_visit=False): path sets
    and their enumeration order equal the host's."""
    pairs = [("p2", "p41"), ("p4", "p78"), ("p6", "p251"),
             ("p8", "p124"), ("p10", "p320")]
    qs = ['{ path as shortest(from: %s, to: %s, numpaths: 2) '
          '{ follows } }'
          % (_uid(stores, a), _uid(stores, b)) for a, b in pairs]
    _check_group(stores, qs, first_visit=False)


@pytest.mark.parametrize("args", ["depth: 2", "minweight: 2, maxweight: 4",
                                  "numpaths: 3, maxweight: 5"])
def test_shortest_bounds_and_edge_lanes(stores, args):
    """Depth caps, weight bounds, a reverse edge, src == dst and an
    unknown uid in one group."""
    u = [_uid(stores, f"p{i}") for i in (1, 2, 3, 4, 5, 6)]
    pairs = [(u[0], u[1]), (u[2], u[2]), (u[3], "0xfffffff"),
             (u[4], u[5]), (u[5], u[0])]
    qs = ['{ path as shortest(from: %s, to: %s, %s) { ~follows } }'
          % (a, b, args) for a, b in pairs]
    first = args == "depth: 2"
    _check_group(stores, qs, first_visit=first)


def test_shortest_mixed_batch_with_recurse_and_leftovers(alpha, stores):
    """Shortest groups beside recurse groups and a leftover, through
    query_batch, in order: equal to the reference Alpha.query_batch."""
    _ref, port = stores
    u = [_uid(stores, f"p{i}") for i in (1, 2, 3, 4, 9, 12, 15, 21)]
    sp = ['{ path as shortest(from: %s, to: %s) { follows } }'
          % (u[i], u[i + 4]) for i in range(4)]
    rec = ['{ q(func: eq(name, "p%d")) @recurse(depth: 3) '
           '{ name score follows } }' % (i * 17 % 400) for i in range(5)]
    odd = ['{ q(func: eq(name, "p3")) { name } }']
    qs = [sp[0], rec[0], sp[1], odd[0], rec[1], sp[2], rec[2],
          sp[3], rec[3], rec[4]]
    plans, leftover = port_batch.plan_batch_groups(
        port, [port_parse(q) for q in qs])
    assert sorted(type(p).__name__ for p, _ in plans) == \
        ["_BatchPlan", "_ShortestPlan"]
    assert leftover == [3]
    want = alpha.query_batch(qs)
    for thr in (0, HOST):
        got = port_batch.query_batch(port, qs, device=CPU,
                                     device_threshold=thr)
        assert json.dumps(got) == json.dumps(want)
