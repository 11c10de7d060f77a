"""Port level-tree lane serving == the JAX package's, exactly.

The scenarios of tests/test_treebatch.py (300 nodes, follows/likes
@reverse, name/score), built once through the reference Alpha and
carried into the port with store_from_arrays, then the LDBC IC mix at
sf=0.02. For every batch:
  * the port's plan_batch_groups forms the reference's groups (same
    family, same members; for trees the same stages);
  * every port group's run_batch serves (no None) on device="cpu";
  * the port's query_batch JSON equals the reference's batch result
    (its run_batch groups plus per-query leftovers) and the port's own
    per-query Engine, byte for byte.
Tolerance: exact — masks, node sets and JSON are compared whole.
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.dql.parser import parse as ref_parse
from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.engine import batch as ref_batch
from dgraph_tpu.models import ldbc as ref_ldbc
from dgraph_tpu.server.api import Alpha
from dgraph_tpu_torch.dql.parser import parse as port_parse
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.engine import batch as port_batch
from dgraph_tpu_torch.engine import treebatch as port_tree
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.store.store import store_from_arrays

CPU = "cpu"
HOST = 10**9
torch.set_num_threads(1)
SCHEMA = """
name: string @index(exact) .
score: int @index(int) .
follows: [uid] @reverse .
likes: [uid] @reverse .
"""


@pytest.fixture(scope="module")
def alpha():
    rng = np.random.default_rng(11)
    a = Alpha(device_threshold=HOST)
    a.alter(SCHEMA)
    n = 300
    lines = [f'_:p{i} <name> "p{i}" .\n_:p{i} <score> "{i % 17}"^^<xs:int> .'
             for i in range(n)]
    for i in range(n):
        for j in rng.choice(n, 5, replace=False):
            if i != j:
                lines.append(f"_:p{i} <follows> _:p{j} .")
        for j in rng.choice(n, 2, replace=False):
            if i != j:
                lines.append(f"_:p{i} <likes> _:p{j} .")
    a.mutate(set_nquads="\n".join(lines))
    return a


@pytest.fixture(scope="module")
def stores(alpha):
    ref = alpha.mvcc.read_view(alpha.oracle.read_only_ts())
    return ref, store_from_arrays(ref)


def _stage_view(plan):
    return [(s.kind, s.attr, s.reverse, s.parent, s.depth, s.keep_hops,
             s.path, s.filt_slot, s.filt_shape) for s in plan.stages]


def _plan_view(plan):
    """A plan's family and structure, comparable across the packages."""
    kind = type(plan).__name__
    if kind == "TreePlan":
        return (kind, plan.sig, _stage_view(plan), plan.seed_blocks,
                plan.filt_paths)
    if kind == "_ShortestPlan":
        return (kind, plan.sig, plan.block_idx, plan.src_uids,
                plan.dst_uids)
    return (kind, plan.attr, plan.reverse, plan.depth)


def check_batch(ref, port, qs, expect_kernel=True, thresholds=(HOST,)):
    """Plans equal, every port group served, JSON equal three ways."""
    r_plans, r_left = ref_batch.plan_batch_groups(
        ref, [ref_parse(q) for q in qs])
    p_plans, p_left = port_batch.plan_batch_groups(
        port, [port_parse(q) for q in qs])
    assert [(_plan_view(p), i) for p, i in p_plans] == \
        [(_plan_view(p), i) for p, i in r_plans]
    assert p_left == r_left
    if expect_kernel:
        assert p_plans and not p_left, p_left
    ref_eng = RefEngine(ref, device_threshold=HOST)
    want = [None] * len(qs)
    for plan, idxs in r_plans:
        out = ref_batch.run_batch(ref, plan, HOST)
        assert out is not None
        for i, o in zip(idxs, out):
            want[i] = o
    for i in r_left:
        want[i] = ref_eng.query(qs[i])
    body = json.dumps(want)
    for plan, idxs in p_plans:
        out = port_batch.run_batch(port, plan, CPU, HOST)
        assert out is not None, type(plan).__name__
        assert json.dumps(out) == json.dumps([want[i] for i in idxs])
    for thr in thresholds:
        got = port_batch.query_batch(port, qs, device=CPU,
                                     device_threshold=thr)
        assert json.dumps(got) == body
    eng = Engine(port, device=CPU, device_threshold=HOST)
    assert json.dumps([eng.query(q) for q in qs]) == body
    return p_plans


def test_two_level_tree(stores):
    qs = ['{ q(func: eq(name, "p%d")) { follows { follows { name } } } }'
          % (i * 13 % 300) for i in range(8)]
    plans = check_batch(*stores, qs, thresholds=(0, HOST))
    assert isinstance(plans[0][0], port_tree.TreePlan)
    assert len(plans[0][0].stages) == 2


def test_filtered_level_with_order_and_pagination(stores):
    qs = ['{ q(func: eq(name, "p%d")) { follows '
          '(orderdesc: score, first: 3) @filter(ge(score, %d)) '
          '{ name score } } }' % (i * 7 % 300, i % 5)
          for i in range(10)]
    check_batch(*stores, qs)


def test_filtered_recurse(stores):
    qs = ['{ q(func: eq(name, "p%d")) @recurse(depth: 3, loop: false) '
          '{ name follows @filter(ge(score, 4)) } }' % (i * 13 % 300)
          for i in range(8)]
    plans = check_batch(*stores, qs, thresholds=(0, HOST))
    assert plans[0][0].stages[0].kind == "recurse"


def test_filtered_recurse_seeds_outside_filter(stores):
    """Seeds the filter excludes stay in the reachable set and still
    expand, as in the reference and the host loop."""
    qs = ['{ q(func: eq(score, %d)) @recurse(depth: 2, loop: false) '
          '{ uid score follows @filter(ge(score, 9)) } }' % (i % 4)
          for i in range(6)]
    plans = check_batch(*stores, qs)
    assert plans[0][0].stages[0].filt_slot == 0


def test_or_filter_and_branching_tree(stores):
    qs = ['{ q(func: eq(name, "p%d")) { follows '
          '@filter(eq(score, 3) OR eq(score, 5)) '
          '{ name likes { name } ~follows (first: 2) { name } } } }'
          % (i * 11 % 300) for i in range(8)]
    check_batch(*stores, qs)


def test_var_chained_blocks(stores):
    """IC9 shape: an internal var block feeds a uid(var) block whose
    stages chain off it inside the same run."""
    qs = ['{ var(func: eq(name, "p%d")) { follows { f as follows } } '
          '  q(func: uid(f)) { ~likes (first: 4) { name } } }'
          % (i * 13 % 300) for i in range(8)]
    plans = check_batch(*stores, qs)
    plan = plans[0][0]
    assert len(plan.stages) == 3 and plan.stages[2].parent == ("stage", 1)


def test_recurse_var_feeds_host_block(stores):
    """IC1 shape: an internal @recurse defines v; a host-rendered block
    roots on uid(v) with filter, order and pagination."""
    qs = ['{ v as var(func: eq(name, "p%d")) '
          '@recurse(depth: 3, loop: false) { follows } '
          '  q(func: uid(v), orderasc: name, first: 5) '
          '@filter(le(score, 12)) { name score } }' % (i * 17 % 300)
          for i in range(8)]
    plans = check_batch(*stores, qs, thresholds=(0, HOST))
    assert isinstance(plans[0][0], port_tree.TreePlan)


def test_ineligible_shapes_fall_back(stores):
    """normalize, groupby → no group; the per-query Engine serves them."""
    ref, port = stores
    qs = ['{ q(func: eq(name, "p1")) @normalize { follows { name } } }',
          '{ q(func: eq(name, "p2")) { follows @groupby(score) '
          '{ count(uid) } } }'] * 3
    plans, leftover = port_batch.plan_batch_groups(
        port, [port_parse(q) for q in qs])
    r_plans, r_left = ref_batch.plan_batch_groups(
        ref, [ref_parse(q) for q in qs])
    assert not plans and not r_plans and leftover == r_left == list(range(6))


def test_mixed_groups_split(stores):
    fwd = ['{ q(func: eq(name, "p%d")) { follows { name } } }' % i
           for i in range(5)]
    deep = ['{ q(func: eq(name, "p%d")) { follows { follows '
            '{ name } } } }' % i for i in range(5)]
    rec = ['{ q(func: eq(name, "p%d")) @recurse(depth: 2) '
           '{ name follows } }' % i for i in range(4)]
    plans = check_batch(*stores, fwd + rec + deep)
    assert sorted(type(p).__name__ for p, _ in plans) == \
        ["TreePlan", "TreePlan", "_BatchPlan"]


def test_tree_group_with_leftovers_in_order(alpha, stores):
    """A tree group, a group below MIN_BATCH, an unparsable query and a
    shape no family takes, in one query_batch call: results in order,
    equal to the reference Alpha.query_batch, error objects included."""
    _ref, port = stores
    tree = ['{ q(func: eq(name, "p%d")) { follows { name } } }' % i
            for i in range(5)]
    small = ['{ q(func: eq(name, "p%d")) { likes { likes { name } } } }'
             % i for i in range(2)]
    odd = ['{ q(func: }',
           '{ q(func: eq(name, "p1")) { follows '
           '@filter(not eq(score, 3)) { name } } }']
    qs = [tree[0], odd[0], small[0], tree[1], tree[2], odd[1], tree[3],
          small[1], tree[4]]
    want = alpha.query_batch(qs)
    got = port_batch.query_batch(port, qs, device=CPU)
    assert json.dumps(got) == json.dumps(want)
    assert "errors" in got[1]


# ---------------------------------------------------------------------------
# LDBC IC mix at sf=0.02

@pytest.fixture(scope="module")
def snb():
    g = ref_ldbc.generate(sf=0.02)
    a = Alpha(device_threshold=HOST)
    ref_ldbc.load_into(a, g)
    ref = a.mvcc.read_view(a.oracle.read_only_ts())
    return g, ref, store_from_arrays(ref)


FAMILY = {**{f"IC{i}": "TreePlan" for i in range(1, 13)},
          "IC13": "_ShortestPlan", "IC14": None, "config3": "TreePlan"}


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_ic_template_family_equals_reference(snb, name):
    """IC1-IC12 and config 3 plan as level trees, IC13 as a shortest
    group and IC14 as a leftover, in both packages, with the same stages
    (kinds, predicates, parents, filter shapes)."""
    g, ref, port = snb
    qs = dict(ref_ldbc.ic_templates(g))
    qs["config3"] = ldbc.config3_query(g)
    batch = [qs[name]] * 4
    r_plans, r_left = ref_batch.plan_batch_groups(
        ref, [ref_parse(q) for q in batch])
    p_plans, p_left = port_batch.plan_batch_groups(
        port, [port_parse(q) for q in batch])
    assert [_plan_view(p) for p, _ in p_plans] == \
        [_plan_view(p) for p, _ in r_plans]
    assert p_left == r_left
    if FAMILY[name] is None:
        assert not p_plans and p_left == [0, 1, 2, 3]
    else:
        assert [type(p).__name__ for p, _ in p_plans] == [FAMILY[name]]
        assert not p_left


def test_ldbc_mixed_batch_distinct_persons(snb):
    """Four instances of every template, each lane its own start person:
    14 kernel groups and IC14 left over, every response equal to the
    reference batch and to the port's per-query Engine."""
    g, ref, port = snb
    qs = [q for _name, q in ldbc.ic_batch(g, copies=4, seed=3,
                                          ic14_copies=2)]
    plans = check_batch(ref, port, qs, expect_kernel=False)
    assert len(plans) == 14
    assert sum(len(i) for _p, i in plans) == len(qs) - 2


@pytest.mark.parametrize("family", ["tree", "shortest"])
def test_kernel_failure_raises_out_of_query_batch(stores, monkeypatch,
                                                  family):
    """No fallback hides the card: a hop that fails inside a kernel
    group raises out of query_batch instead of sending the group to the
    per-query engine."""
    from dgraph_tpu_torch.ops import bfs

    ref, port = stores
    if family == "tree":
        qs = ['{ q(func: eq(name, "p%d")) { follows { name } } }' % i
              for i in range(4)]
    else:
        u = [hex(int(ref.uids[i])) for i in range(8)]
        qs = ['{ path as shortest(from: %s, to: %s) { follows } }'
              % (u[i], u[i + 4]) for i in range(4)]

    def failing_hop(*_a, **_k):
        raise RuntimeError("bucket_hop launch failed")

    monkeypatch.setattr(bfs, "_ell_hop", failing_hop)
    with pytest.raises(RuntimeError, match="launch failed"):
        port_batch.query_batch(port, qs, device=CPU)


def test_query_error_in_host_rebuild_goes_per_query(alpha, stores):
    """A tree group whose host rebuild raises the query's own error (a
    host-only block reading a variable no block defines, which the
    reference refuses too) is served per query, which gives each of its
    queries its error object; the other groups still run."""
    ref, port = stores
    bad = ['{ q(func: eq(name, "p%d")) { follows { name } } '
           'r(func: uid(nope)) { name } }' % i for i in range(4)]
    tree = ['{ q(func: eq(name, "p%d")) { follows { follows { name } } } }'
            % i for i in range(4)]
    plans, _left = port_batch.plan_batch_groups(
        port, [port_parse(q) for q in bad + tree])
    assert len(plans) == 2
    assert port_batch.run_batch(port, plans[0][0], CPU) is None
    eng = Engine(port, device=CPU)
    with pytest.raises(ValueError, match="not defined") as err:
        eng.query(bad[0])
    with pytest.raises(ValueError) as ref_err:
        RefEngine(ref, device_threshold=HOST).query(bad[0])
    assert str(err.value) == str(ref_err.value)
    got = port_batch.query_batch(port, bad + tree, device=CPU)
    assert got[:4] == [{"errors": [{"message": str(err.value)}]}] * 4
    assert json.dumps(got[4:]) == json.dumps(alpha.query_batch(tree))


def test_aggregate_and_math_queries_run_as_tree_groups(alpha, stores):
    """Aggregates, value variables and math() leave a query eligible for
    a tree group: its hops run on the lane run and its host rebuild
    renders them, equal to the reference."""
    _ref, port = stores
    qs = ['{ q(func: eq(name, "p%d")) { follows { s as score '
          'n as count(follows) m: math(s * 2 + n) follows { name } } '
          'lo: min(val(s)) hi: max(val(s)) } }' % i for i in range(6)]
    plans, left = port_batch.plan_batch_groups(
        port, [port_parse(q) for q in qs])
    assert left == [] and len(plans) == 1
    assert isinstance(plans[0][0], port_tree.TreePlan)
    got = port_batch.query_batch(port, qs, device=CPU)
    assert "errors" not in json.dumps(got)
    assert json.dumps(got) == json.dumps(alpha.query_batch(qs))
