"""Port batched @recurse serving == the JAX package, byte for byte.

The fixture is tests/test_batch.py's (400 nodes, name/score/follows
@reverse), built once through the reference Alpha and carried into the
port with store_from_arrays. The port runs with device="cpu".
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dgraph_tpu.dql.parser import parse as ref_parse
from dgraph_tpu.engine import Engine
from dgraph_tpu.engine.batch import plan_batch as ref_plan_batch
from dgraph_tpu.engine.batch import run_batch as ref_run_batch
from dgraph_tpu.server.api import Alpha
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu_torch.dql.parser import parse as port_parse
from dgraph_tpu_torch.engine import batch as port_batch
from dgraph_tpu_torch.store.schema import parse_schema as port_parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder as PortBuilder
from dgraph_tpu_torch.store.store import store_from_arrays

CPU = "cpu"
# one intra-op thread: the suite runs files in parallel workers, and
# torch's default pool would compete with their timing-sensitive tests
torch.set_num_threads(1)
SCHEMA = """
name: string @index(exact) .
score: int .
follows: [uid] @reverse .
"""


@pytest.fixture(scope="module")
def alpha():
    rng = np.random.default_rng(5)
    a = Alpha(device_threshold=10**9)
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


def _queries(n, depth, edge="follows", leaves="name score"):
    return [('{ q(func: eq(name, "p%d")) @recurse(depth: %d) '
             '{ %s %s } }' % (i * 17 % 400, depth, leaves, edge))
            for i in range(n)]


@pytest.mark.parametrize("edge", ["follows", "~follows"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_query_batch_equals_reference(stores, edge, depth):
    ref, port = stores
    qs = _queries(12, depth, edge)
    plan = ref_plan_batch(ref, [ref_parse(q) for q in qs])
    assert plan is not None
    want = ref_run_batch(ref, plan, 10**9)
    eng = Engine(ref, device_threshold=10**9)
    assert want == [eng.query(q) for q in qs]
    got = port_batch.query_batch(port, qs, device=CPU)
    assert json.dumps(got) == json.dumps(want)


def test_query_batch_mixed_groups_and_leaves(stores):
    """Two groups (different depths) in one batch, uid/count leaves, and
    the results come back in request order."""
    ref, port = stores
    a = _queries(5, 2, leaves="uid name count(follows)")
    b = _queries(6, 3, edge="~follows", leaves="score")
    qs = [q for pair in zip(a, b) for q in pair] + b[5:]
    eng = Engine(ref, device_threshold=10**9)
    got = port_batch.query_batch(port, qs, device=CPU)
    assert json.dumps(got) == json.dumps([eng.query(q) for q in qs])


def test_ineligible_query_raises(alpha, stores):
    """Queries no recurse group takes (ineligible, below MIN_BATCH,
    unparsable) no longer raise: the per-query Engine serves them, and
    the batch equals the reference Alpha.query_batch, error objects
    included."""
    _ref, port = stores
    for qs in (_queries(6, 2) + ['{ q(func: eq(name, "p3")) '
                                 '{ name score follows { name } } }'],
               _queries(2, 2),                       # below MIN_BATCH
               _queries(6, 2) + ["{ q(func: }"]):    # a ParseError
        want = alpha.query_batch(qs)
        for threshold in (0, 10**9):
            got = port_batch.query_batch(port, qs, device=CPU,
                                         device_threshold=threshold)
            assert json.dumps(got) == json.dumps(want)
    assert "errors" in want[-1]


SHAPES = [
    '{ q(func: eq(name, "p1")) @recurse(depth: 3) { name score follows } }',
    '{ q(func: eq(name, "p1", "p2")) @recurse(depth: 2, loop: false) '
    '{ uid n: name count(follows) ~follows } }',
    '{ q(func: uid(0x1, 0x2)) @recurse(depth: 4) { name follows } }',
    'query Q($d: int = "2") { q(func: eq(name, "p7")) @recurse(depth: $d) '
    '{ name@en:. follows } }',
    '{ a as q(func: eq(name, "p1")) @filter(ge(score, 3)) '
    '{ follows (first: 2) @filter(not eq(name, "p2")) { name } } }',
]


@pytest.mark.parametrize("q", SHAPES)
def test_parse_equals_reference(q):
    want = [dataclasses.asdict(b) for b in ref_parse(q)]
    got = [dataclasses.asdict(b) for b in port_parse(q)]
    assert got == want


def test_schema_and_builder_equal_reference():
    text = SCHEMA + "tags: [string] @index(exact, term) .\nseen: datetime .\n"
    assert port_parse_schema(text).to_text() == \
        ref_parse_schema(text).to_text()
    rng = np.random.default_rng(2)
    rb, pb = RefBuilder(ref_parse_schema(text)), \
        PortBuilder(port_parse_schema(text))
    uids = rng.choice(10_000, 60, replace=False) + 1
    pairs = rng.integers(0, 60, (200, 2)).tolist()
    for b in (rb, pb):
        for i, u in enumerate(uids.tolist()):
            b.add_value(u, "name", f"p{i}")
            b.add_value(u, "score", i % 7)
            b.add_value(u, "tags", "Red fish" if i % 3 else "blue Fish")
            b.add_value(u, "seen", "2020-01-0%dT10:00:00Z" % (1 + i % 9))
        for s, o in pairs:
            b.add_edge(int(uids[s]), "follows", int(uids[o]))
    r, p = rb.finalize(), pb.finalize()
    assert np.array_equal(r.uids, p.uids)
    assert sorted(r.preds) == sorted(p.preds)
    for name, rpd in r.preds.items():
        ppd = p.preds[name]
        for d in ("fwd", "rev"):
            a, b = getattr(rpd, d), getattr(ppd, d)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.indptr, b.indptr)
                assert np.array_equal(a.indices, b.indices)
        assert sorted(rpd.vals) == sorted(ppd.vals)
        for lang, col in rpd.vals.items():
            assert np.array_equal(col.subj, ppd.vals[lang].subj)
            assert list(col.vals) == list(ppd.vals[lang].vals)
        assert rpd.index.keys() == ppd.index.keys()
        for tk, inv in rpd.index.items():
            assert inv.keys() == ppd.index[tk].keys()
            for t, ranks in inv.items():
                assert np.array_equal(ranks, ppd.index[tk][t])
