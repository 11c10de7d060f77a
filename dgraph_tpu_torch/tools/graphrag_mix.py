"""The GraphRAG mix over the LDBC SNB graph: `similar_to` retrieval and
`@msgpass` feature traversal.

Every message (post and comment) and every person carries a
`float32vector` embedding of DIM = 384 components, the width of
all-MiniLM-L6-v2, a common sentence embedding of GraphRAG pipelines:

    emb: float32vector @dim(384) .

Components are small integers in [0, 7) drawn with numpy from EMB_SEED
(bench.py's graphrag and featprop fixtures draw theirs the same way), so
every score (at most 384 * 36) and every sum is exact in float32 and the
host, device and whole-block routes agree bit for bit. Query vectors come
from QUERY_SEED in the same range.

Nine templates on LDBC's predicates, after bench.py's two fixtures:

    knn_hop          similar_to(emb, 10, vec) → has_creator → first_name
    knn_uid          similar_to(emb, 10, <message uid>) → has_tag
    knn_recurse      similar_to(emb, 32, vec) @recurse(depth: 3) reply_of
    featprop_{sum,mean,max}
                     uid(P) @recurse(depth: 2) @msgpass(agg) over knows
    knn_featprop     similar_to(emb, 16, vec) @recurse(depth: 2)
                     @msgpass(mean) over ~reply_of
    msgpass_author   uid(P) @msgpass(mean) { ~has_creator }
    msgpass_hub      eq(tag_name, "tag_1") @msgpass(sum) { ~has_tag }

`load_into(builder, g)` adds the schema line and the vectors (numpy
rows, one `StoreBuilder.add_value` each) to a builder that holds the LDBC graph;
`templates(g)` gives the queries, `batch(g)` a serving batch.
"""

from __future__ import annotations

import numpy as np

from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.store.schema import parse_schema

DIM = 384
EMB_SEED = 11
QUERY_SEED = 12
BATCH_SEED = 5             # draws the start persons of `batch`

# %(v)s: a query vector literal; %(m)s: a message uid; %(p)s: a person uid
TEMPLATES = {
    "knn_hop": '{ q(func: similar_to(emb, 10, "%(v)s")) '
               '{ uid has_creator { uid first_name } } }',
    "knn_uid": '{ q(func: similar_to(emb, 10, %(m)s)) '
               '{ uid has_tag { tag_name } } }',
    "knn_recurse": '{ q(func: similar_to(emb, 32, "%(v)s")) '
                   '@recurse(depth: 3, loop: false) { uid reply_of } }',
    "featprop_sum": '{ q(func: uid(%(p)s)) @recurse(depth: 2, loop: false) '
                    '@msgpass(pred: emb, agg: sum) { uid knows } }',
    "featprop_mean": '{ q(func: uid(%(p)s)) @recurse(depth: 2, loop: false) '
                     '@msgpass(pred: emb, agg: mean) { uid knows } }',
    "featprop_max": '{ q(func: uid(%(p)s)) @recurse(depth: 2, loop: false) '
                    '@msgpass(pred: emb, agg: max) { uid knows } }',
    "knn_featprop": '{ q(func: similar_to(emb, 16, "%(v)s")) '
                    '@recurse(depth: 2, loop: false) '
                    '@msgpass(pred: emb, agg: mean) { uid ~reply_of } }',
    "msgpass_author": '{ q(func: uid(%(p)s)) @msgpass(pred: emb, agg: mean) '
                      '{ ~has_creator { uid } } }',
    "msgpass_hub": '{ q(func: eq(tag_name, "tag_1")) '
                   '@msgpass(pred: emb, agg: sum) { ~has_tag { uid } } }',
}
NAMES = tuple(TEMPLATES)


def emb_rows(g: ldbc.SNBGraph, dim: int = DIM):
    """(uids, vecs [n, dim] float32): one row per person and message."""
    uids = np.concatenate([g.person_uids, g.post_uids, g.comment_uids])
    rng = np.random.default_rng(EMB_SEED)
    vecs = rng.integers(0, 7, (len(uids), dim), dtype=np.int8)
    return uids, vecs.astype(np.float32)


def load_into(builder, g: ldbc.SNBGraph, dim: int = DIM) -> None:
    """Add the `emb` predicate and its rows to a builder holding `g`."""
    builder.schema.update(parse_schema(
        f"emb: float32vector @dim({dim}) ."))
    uids, vecs = emb_rows(g, dim)
    for u, row in zip(uids.tolist(), vecs):
        builder.add_value(u, "emb", row)


def _literal(v) -> str:
    return "[%s]" % ", ".join(str(int(x)) for x in v)


def _params(g: ldbc.SNBGraph, person: int, v) -> dict:
    return {"v": _literal(v), "p": hex(person),
            "m": hex(int(g.post_uids[len(g.post_uids) // 3]))}


def templates(g: ldbc.SNBGraph, dim: int = DIM) -> dict[str, str]:
    """The nine templates with `ic_params(g)`'s person and the first query
    vector of QUERY_SEED."""
    v = np.random.default_rng(QUERY_SEED).integers(0, 7, dim)
    params = _params(g, ldbc.ic_params(g)["p"], v)
    return {name: t % params for name, t in TEMPLATES.items()}


def batch(g: ldbc.SNBGraph, knn_copies: int = 32, feat_copies: int = 8,
          dim: int = DIM) -> list[tuple[str, str]]:
    """A serving batch of (template name, DQL) pairs: `knn_copies`
    instances each of knn_hop and knn_recurse with distinct query vectors
    (QUERY_SEED, after the one `templates` uses), then `feat_copies` of
    each featprop template with distinct start persons (BATCH_SEED)."""
    rng = np.random.default_rng(QUERY_SEED)
    rng.integers(0, 7, dim)
    vecs = rng.integers(0, 7, (knn_copies, dim))
    persons = np.random.default_rng(BATCH_SEED).choice(
        g.person_uids, size=feat_copies, replace=False)
    out = []
    for c in range(knn_copies):
        params = _params(g, int(persons[c % feat_copies]), vecs[c])
        out += [(name, TEMPLATES[name] % params)
                for name in ("knn_hop", "knn_recurse")]
    for c in range(feat_copies):
        params = _params(g, int(persons[c]), vecs[0])
        out += [(name, TEMPLATES[name] % params)
                for name in ("featprop_sum", "featprop_mean",
                             "featprop_max")]
    return out
