"""The port's GraphRAG mix (tools/graphrag_mix.py) == the JAX package's.

At sf=0.02 (seed 9) with 8-d embeddings (the tool's vectors and query
vectors, cut to 8 components): the LDBC graph plus `emb` built through
the port's StoreBuilder (numpy rows) and through the reference
StoreBuilder (lists), one add_value per row. Each of the nine templates, served
by the port Engine on the CPU at device_threshold 0, 512 and 10**9, gives
the reference Engine's JSON exactly, and plans the same whole-block
stages. A query_batch of knn_hop, knn_recurse and featprop instances
plans knn_recurse into the recurse family, knn_hop into a level tree and
the @msgpass queries to the per-query engine, and equals the per-query
Engine response for response. Exact everywhere (small-integer vectors).
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.dql.parser import parse as ref_parse
from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.engine import fused as ref_fused
from dgraph_tpu.models import ldbc as ref_ldbc
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu_torch.dql.parser import parse
from dgraph_tpu_torch.engine import Engine, batch, fused
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.tools import graphrag_mix

CPU = "cpu"
SF = 0.02
DIM = 8
torch.set_num_threads(1)


def _ref_store(g, uids, vecs):
    """The reference store: the LDBC graph as models/ldbc.load_into puts
    it, then one `emb` value per row."""
    b = RefBuilder(ref_parse_schema(ref_ldbc.SCHEMA))
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
    b.schema.update(ref_parse_schema(f"emb: float32vector @dim({DIM}) ."))
    for u, v in zip(uids.tolist(), vecs):
        b.add_value(u, "emb", v)
    return b.finalize()


@pytest.fixture(scope="module")
def rag():
    pg = ldbc.generate(sf=SF)
    b = StoreBuilder()
    ldbc.load_into(b, pg)
    graphrag_mix.load_into(b, pg, DIM)
    ref = _ref_store(ref_ldbc.generate(sf=SF),
                     *graphrag_mix.emb_rows(pg, DIM))
    return pg, ref, b.finalize()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    fused.reset()
    ref_fused.reset()


def test_tablet_equals_reference(rag):
    pg, ref, store = rag
    t0, t1 = ref.vec_tablet("emb"), store.vec_tablet("emb")
    assert t1.rows == len(pg.person_uids) + len(pg.post_uids) \
        + len(pg.comment_uids)
    assert t0.subj.tolist() == t1.subj.tolist()
    assert t0.vecs.tobytes() == t1.vecs.tobytes()


@pytest.mark.parametrize("threshold", [0, 512, 10**9])
@pytest.mark.parametrize("name", graphrag_mix.NAMES)
def test_template_equals_reference(rag, name, threshold):
    pg, ref, store = rag
    q = graphrag_mix.templates(pg, DIM)[name]
    want = RefEngine(ref, device_threshold=threshold).query(q)
    got = Engine(store, device=CPU, device_threshold=threshold).query_bytes(q)
    assert got == json.dumps(want, separators=(",", ":")).encode()
    assert next(iter(want.values()))           # a non-empty answer
    kinds = [[s.kind for s in p.stages] if p else None
             for p in (fused.plan_block(store, sg) for sg in parse(q))]
    assert kinds == [[s.kind for s in p.stages] if p else None
                     for p in (ref_fused.plan_block(ref, sg)
                               for sg in ref_parse(q))]
    assert fused.status()["fallbacks"] == 0


def test_batch_plans_and_equals_per_query_engine(rag):
    from dgraph_tpu_torch.engine.batch import _BatchPlan
    from dgraph_tpu_torch.engine.treebatch import TreePlan

    pg, _ref, store = rag
    pairs = graphrag_mix.batch(pg, knn_copies=6, feat_copies=4, dim=DIM)
    qs = [q for _n, q in pairs]
    plans, leftover = batch.plan_batch_groups_cached(store, qs)
    fam = {type(p): sorted({pairs[i][0] for i in idxs})
           for p, idxs in plans}
    assert fam == {_BatchPlan: ["knn_recurse"], TreePlan: ["knn_hop"]}
    assert sorted({pairs[i][0] for i in leftover}) == [
        "featprop_max", "featprop_mean", "featprop_sum"]
    got = batch.query_batch(store, qs, device=CPU)
    eng = Engine(store, device=CPU)
    for (name, q), r in zip(pairs, got):
        assert json.dumps(r, sort_keys=True) == json.dumps(
            eng.query(q), sort_keys=True), name
    assert len({q for _n, q in pairs}) == len(pairs)   # distinct instances
