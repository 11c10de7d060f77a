"""The port's LDBC SNB model and per-query engine == the JAX package's.

At sf=0.02 (seed 9):
  1. the port generator's arrays equal the reference generator's;
  2. the port's load_into store equals store_from_arrays of the reference
     Alpha's read view (CSR both ways, value columns, token indexes,
     edge facets, rev_pos);
  3. all 14 IC templates and the config-3 query, served by the port
     Engine on the CPU over the port-built store, give the reference
     Alpha.query JSON exactly, with device_threshold 0 (the torch ops)
     and 10**9 (the host walk), and query_bytes equals the compact
     json.dumps of the reference's dict.
Exact everywhere: facet weights are float64 copies, not recomputed.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dgraph_tpu.models import ldbc as ref_ldbc
from dgraph_tpu.server.api import Alpha
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.store.store import StoreBuilder, store_from_arrays
from dgraph_tpu_torch.tools import feature_mix

CPU = "cpu"
SF = 0.02
torch.set_num_threads(1)
FIELDS = [f.name for f in dataclasses.fields(ref_ldbc.SNBGraph)]
PREDS = ["knows", "has_creator", "reply_of", "has_tag", "has_member",
         "container_of", "likes", "works_at", "first_name", "last_name",
         "city", "birthday_year", "creation_ts", "tag_name", "forum_title",
         "org_name"]


@pytest.fixture(scope="module")
def snb():
    g = ref_ldbc.generate(sf=SF)
    a = Alpha(device_threshold=10**9)
    ref_ldbc.load_into(a, g)
    view = a.mvcc.read_view(a.oracle.read_only_ts())
    pg = ldbc.generate(sf=SF)
    b = StoreBuilder()
    ldbc.load_into(b, pg)
    return a, g, view, pg, b.finalize()


@pytest.mark.parametrize("name", FIELDS)
def test_generator_equals_reference(snb, name):
    _a, g, _view, pg, _store = snb
    want, got = getattr(g, name), getattr(pg, name)
    if isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and np.array_equal(want, got)
    else:
        assert want == got
    assert ldbc.ic_params(pg) == ref_ldbc.ic_params(g)
    assert ldbc.ic_templates(pg) == ref_ldbc.ic_templates(g)


@pytest.mark.parametrize("pred", PREDS)
def test_load_into_equals_reference_view(snb, pred):
    _a, _g, view, _pg, store = snb
    want = store_from_arrays(view)
    assert np.array_equal(want.uids, store.uids)
    w, p = want.preds[pred], store.preds[pred]
    assert w.schema == p.schema
    for d in ("fwd", "rev"):
        a, b = getattr(w, d), getattr(p, d)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a.indptr, b.indptr)
            assert np.array_equal(a.indices, b.indices)
    assert w.vals.keys() == p.vals.keys()
    for lang, col in w.vals.items():
        assert np.array_equal(col.subj, p.vals[lang].subj)
        assert col.vals.dtype == p.vals[lang].vals.dtype
        assert list(col.vals) == list(p.vals[lang].vals)
    assert w.index.keys() == p.index.keys()
    for tk, inv in w.index.items():
        assert inv.keys() == p.index[tk].keys()
        for t, ranks in inv.items():
            assert np.array_equal(ranks, p.index[tk][t])
    assert w.efacets.keys() == p.efacets.keys()
    for k, col in w.efacets.items():
        assert np.array_equal(col.pos, p.efacets[k].pos)
        assert [type(v) for v in col.vals] == \
            [type(v) for v in p.efacets[k].vals]
        assert list(col.vals) == list(p.efacets[k].vals)
    assert w.vfacets == p.vfacets
    w.build_rev_pos(want.n_nodes)
    p.build_rev_pos(store.n_nodes)
    assert (w.rev_pos is None) == (p.rev_pos is None)
    if w.rev_pos is not None:
        assert np.array_equal(w.rev_pos, p.rev_pos)


def _queries(g):
    qs = dict(ref_ldbc.ic_templates(g))
    qs["config3"] = ('{ q(func: eq(city, "%s")) @recurse(depth: 3, '
                     'loop: false) { uid knows @filter(ge(birthday_year, '
                     '1980)) } }' % g.city[0])
    return qs


QUERY_NAMES = [f"IC{i}" for i in range(1, 15)] + ["config3"]


@pytest.mark.parametrize("threshold", [0, 10**9])
@pytest.mark.parametrize("name", QUERY_NAMES)
def test_ic_template_equals_reference(snb, name, threshold):
    a, g, _view, pg, store = snb
    q = _queries(g)[name]
    assert ldbc.config3_query(pg) == _queries(g)["config3"]
    want = a.query(q)
    eng = Engine(store, device=CPU, device_threshold=threshold)
    assert eng.query(q) == want
    assert eng.query_bytes(q) == json.dumps(
        want, separators=(",", ":")).encode()
    assert next(iter(want.values()))       # a non-empty answer
    if threshold == 0:
        assert eng.routes.expansions["numpy"] == 0
        assert eng.routes.on_device() > 0


# -- the DQL-feature mix (tools/feature_mix.py) ---------------------------------

def _ref_feature_store(g, ext):
    """The reference store of the feature mix, built through the
    reference StoreBuilder from the same graph and extension values."""
    from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
    from dgraph_tpu.store.store import StoreBuilder as RefBuilder

    b = RefBuilder(ref_parse_schema(ref_ldbc.SCHEMA))
    b.schema.update(ref_parse_schema(feature_mix.SCHEMA_EXT))
    for (s, o), w in zip(g.knows.tolist(), g.knows_weight.tolist()):
        b.add_edge(s, "knows", o, facets={"weight": float(w)})
    for pred in ("has_creator", "reply_of", "has_tag", "has_member",
                 "container_of", "likes", "works_at"):
        pairs = getattr(g, pred)
        b.add_edges(pred, pairs[:, 0], pairs[:, 1])
    for i, u in enumerate(g.person_uids.tolist()):
        b.add_value(u, "first_name", g.first_name[i])
        b.add_value(u, "last_name", g.last_name[i])
        b.add_value(u, "city", g.city[i])
        b.add_value(u, "birthday_year", int(g.birthday_year[i]))
    msgs = np.concatenate([g.post_uids, g.comment_uids])
    for u, ts in zip(msgs.tolist(), g.creation_ts.tolist()):
        b.add_value(u, "creation_ts", int(ts))
    for i, u in enumerate(g.tag_uids.tolist()):
        b.add_value(u, "tag_name", ref_ldbc.TAG_NAMES[i])
    for i, u in enumerate(g.forum_uids.tolist()):
        b.add_value(u, "forum_title", f"forum_{i}")
    for i, u in enumerate(g.org_uids.tolist()):
        b.add_value(u, "org_name", f"org_{i}")
    for u, pred, v in ext:
        b.add_value(u, pred, v)
    return b.finalize()


@pytest.fixture(scope="module")
def features():
    from dgraph_tpu.engine import Engine as RefEngine

    pg = ldbc.generate(sf=SF)
    ext = feature_mix.extension_values(pg)
    ref = _ref_feature_store(ref_ldbc.generate(sf=SF), ext)
    store = feature_mix.build_store(pg, ext)
    return pg, RefEngine, ref, store


@pytest.mark.parametrize("threshold", [0, 10**9])
@pytest.mark.parametrize("name", feature_mix.NAMES)
def test_feature_template_equals_reference(features, name, threshold):
    pg, RefEngine, ref, store = features
    q = feature_mix.templates(pg)[name]
    want = RefEngine(ref, device_threshold=threshold).query(q)
    eng = Engine(store, device=CPU, device_threshold=threshold)
    assert eng.query_bytes(q) == json.dumps(
        want, separators=(",", ":")).encode()
    assert next(iter(want.values()))       # a non-empty answer


def test_feature_batch_equals_reference(features):
    from dgraph_tpu_torch.engine import batch
    from dgraph_tpu_torch.engine.treebatch import TreePlan

    pg, RefEngine, ref, store = features
    pairs = feature_mix.batch(pg, copies=4)
    qs = [q for _n, q in pairs]
    plans, _left = batch.plan_batch_groups_cached(store, qs)
    tree = {pairs[i][0] for p, idxs in plans if isinstance(p, TreePlan)
            for i in idxs}
    assert {"agg_minmax", "math"} <= tree
    got = batch.query_batch(store, qs, device=CPU)
    eng = RefEngine(ref, device_threshold=10**9)
    for (name, q), r in zip(pairs, got):
        assert json.dumps(r, sort_keys=True) == json.dumps(
            eng.query(q), sort_keys=True), name
