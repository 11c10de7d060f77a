"""The port's MVCC fold against the reference's, array for array.

`dgraph_tpu_torch.store.mvcc._materialize` folds tablets as numpy arrays
where the reference re-adds every posting through its StoreBuilder; the
two must give the same Store for the same base and layers: the same
uids, schema text, predicate order, CSR arrays, value columns (dtype,
subjects, values), facet columns and maps (in the same key order) and
token indexes. Seeded mutation sequences cover every rule the
reference's fold encodes (layer order, deletes before sets, star edge
and value deletes, facets kept by a facet-less set, value deletes that
ignore the value, list append against replace, `dgraph.type`, untyped
predicates typed by their first value, `only=` and `vocab=`), and
`MVCCStore` (read_view, rollup, gc, absorb_straggler) is driven the same
way on both sides. Tolerance: exact.
"""

import json

import numpy as np
import pytest

from dgraph_tpu.store import mvcc as ref_mvcc
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu_torch.store import mvcc
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder

SCHEMA = """
friend: [uid] @reverse .
knows: [uid] .
name: string @index(exact, term) .
nick: string @lang .
tags: [string] @index(exact) .
age: int @index(int) .
score: float .
born: datetime .
flag: bool .
loc: geo @index(geo) .
pw: password .
emb: float32vector .
"""

EDGE_PREDS = ("friend", "knows", "newedge")
LANGS = ("", "en", "fr")


def _norm(v):
    """A value in a form both packages compare equal by."""
    if hasattr(v, "gj"):
        return ("geo", v.gj)
    if isinstance(v, np.ndarray):
        return ("vec", v.dtype.str, v.tolist())
    if isinstance(v, np.datetime64):
        return ("dt", str(v))
    if isinstance(v, np.generic):
        return (type(v.item()).__name__, v.item())
    return (type(v).__name__, v)


def assert_stores_equal(got, want):
    """`got` (port Store) equals `want` (reference Store) array for
    array, including every dict order."""
    np.testing.assert_array_equal(got.uids, want.uids)
    assert got.uids.dtype == want.uids.dtype
    assert got.schema.to_text() == want.schema.to_text()
    assert list(got.preds.keys()) == list(want.preds.keys())
    for p in want.preds.keys():
        a, b = got.preds[p], want.preds[p]
        for side in ("fwd", "rev"):
            ra, rb = getattr(a, side), getattr(b, side)
            assert (ra is None) == (rb is None), (p, side)
            if rb is not None:
                assert ra.indptr.dtype == rb.indptr.dtype
                assert ra.indices.dtype == rb.indices.dtype
                np.testing.assert_array_equal(ra.indptr, rb.indptr)
                np.testing.assert_array_equal(ra.indices, rb.indices)
        assert list(a.vals) == list(b.vals), p
        for lang in b.vals:
            ca, cb = a.vals[lang], b.vals[lang]
            assert ca.subj.dtype == cb.subj.dtype
            np.testing.assert_array_equal(ca.subj, cb.subj)
            assert ca.vals.dtype == cb.vals.dtype, (p, lang)
            assert [_norm(v) for v in ca.vals] == \
                [_norm(v) for v in cb.vals], (p, lang)
        assert list(a.efacets) == list(b.efacets), p
        for k in b.efacets:
            fa, fb = a.efacets[k], b.efacets[k]
            assert fa.pos.dtype == fb.pos.dtype
            np.testing.assert_array_equal(fa.pos, fb.pos)
            assert [_norm(v) for v in fa.vals] == \
                [_norm(v) for v in fb.vals], (p, k)
        assert list(a.vfacets) == list(b.vfacets), p
        for k in b.vfacets:
            assert [(r, _norm(v)) for r, v in a.vfacets[k].items()] == \
                [(r, _norm(v)) for r, v in b.vfacets[k].items()], (p, k)
        assert list(a.index) == list(b.index), p
        for tk in b.index:
            assert sorted(a.index[tk]) == sorted(b.index[tk]), (p, tk)
            for t in b.index[tk]:
                np.testing.assert_array_equal(a.index[tk][t],
                                              b.index[tk][t])


def _value(rng, p, i):
    if p in ("name", "nick", "note"):
        return f"{p}{int(rng.integers(0, 6))}"
    if p == "tags":
        return f"t{int(rng.integers(0, 4))}"
    if p in ("age", "cnt", "newval"):
        return int(rng.integers(0, 50))
    if p == "score":
        return float(rng.choice([0.5, 1.25, -2.0, 3.0]))
    if p == "born":
        return f"19{int(rng.integers(50, 99))}-0{int(rng.integers(1, 9))}-1{int(rng.integers(0, 9))}"
    if p == "flag":
        return bool(rng.integers(0, 2))
    if p == "loc":
        return json.dumps({"type": "Point", "coordinates": [
            float(rng.integers(-50, 50)), float(rng.integers(-40, 40))]})
    if p == "pw":
        return f"scrypt$salt{i}$hash{int(rng.integers(0, 3))}"
    if p == "emb":
        return [float(x) for x in rng.integers(-3, 4, 3)]
    if p == "dgraph.type":
        return str(rng.choice(["Person", "Post"]))
    raise AssertionError(p)


VAL_PREDS = ("name", "nick", "tags", "age", "score", "born", "flag", "loc",
             "pw", "emb", "note", "cnt", "newval", "dgraph.type")


def _facets(rng):
    r = rng.random()
    if r < 0.4:
        return None
    if r < 0.5:
        return ()
    if r < 0.8:
        return {"w": float(rng.integers(1, 9)) / 2}
    return {"since": int(rng.integers(2000, 2020)),
            "w": float(rng.integers(1, 9))}


def _base_triples(rng, n=24):
    """(edges, values) of a base store over uids 1..n."""
    edges, values = [], []
    for _ in range(3 * n):
        p = str(rng.choice(EDGE_PREDS[:2]))
        s, o = (int(x) for x in rng.integers(1, n + 1, 2))
        edges.append((s, p, o, _facets(rng)))
    for i in range(4 * n):
        p = str(rng.choice(VAL_PREDS[:12]))
        s = int(rng.integers(1, n + 1))
        lang = str(rng.choice(LANGS)) if p == "nick" else ""
        f = {"src": f"f{i % 3}"} if (p == "name" and rng.random() < 0.5) \
            else None
        values.append((s, p, _value(rng, p, i), lang, f))
    for s in range(1, n + 1, 3):
        values.append((s, "cnt", int(s), "", None))
    return edges, values


def _build(builder_cls, parse, edges, values):
    b = builder_cls(schema=parse(SCHEMA))
    for s, p, o, f in edges:
        b.add_edge(s, p, o, facets=f or None)
    for s, p, v, lang, f in values:
        if p == "dgraph.type":
            b.add_type(s, v)
        else:
            b.add_value(s, p, v, lang, facets=f)
    return b.finalize()


def _layers(rng, n_layers, n=24):
    """[(commit_ts, {edge_sets, edge_dels, val_sets, val_dels,
    touch_uids})] as plain tuples."""
    out = []
    pool = list(range(1, n + 1)) + [100, 101, 102, 103]
    for li in range(n_layers):
        m = {"edge_sets": [], "edge_dels": [], "val_sets": [],
             "val_dels": [], "touch_uids": []}
        for _ in range(int(rng.integers(1, 7))):
            r = rng.random()
            s = int(rng.choice(pool))
            if r < 0.25:
                p = str(rng.choice(EDGE_PREDS))
                o = int(rng.choice(pool))
                f = _facets(rng)
                m["edge_sets"].append((s, p, o, f) if rng.random() < 0.8
                                      else (s, p, o))
            elif r < 0.35:
                p = str(rng.choice(EDGE_PREDS))
                o = int(rng.choice(pool + [999]))
                m["edge_dels"].append((s, p, o))
            elif r < 0.42:
                m["edge_dels"].append((s, str(rng.choice(EDGE_PREDS)),
                                       None))
            elif r < 0.75:
                p = str(rng.choice(VAL_PREDS))
                lang = (str(rng.choice(LANGS)) if p in ("nick", "name")
                        else "")
                f = ({"src": f"L{li}"} if p in ("name", "nick")
                     and rng.random() < 0.4 else None)
                m["val_sets"].append((s, p, _value(rng, p, li), lang, f))
            elif r < 0.88:
                p = str(rng.choice(VAL_PREDS))
                lang = str(rng.choice(LANGS)) if p == "nick" else ""
                m["val_dels"].append((s, p, None, lang))
            elif r < 0.97:
                m["val_dels"].append((s, str(rng.choice(VAL_PREDS)), None,
                                      "*"))
            else:
                m["touch_uids"].append(int(rng.integers(200, 210)))
        out.append((10 + 10 * li, m))
    return out


def _case(seed, n_layers=12, empty_base=False):
    rng = np.random.default_rng(seed)
    edges, values = ([], []) if empty_base else _base_triples(rng)
    port_base = _build(StoreBuilder, parse_schema, edges, values)
    ref_base = _build(RefBuilder, ref_parse_schema, edges, values)
    raw = _layers(rng, n_layers)
    port_layers = [mvcc._Layer(ts, mvcc.Mutation(**m)) for ts, m in raw]
    ref_layers = [ref_mvcc._Layer(ts, ref_mvcc.Mutation(**m))
                  for ts, m in raw]
    return port_base, ref_base, port_layers, ref_layers


def _fold_or_error(fn, *a, **kw):
    try:
        return fn(*a, **kw), None
    except ValueError as e:
        return None, type(e).__name__


SEEDS = list(range(16))


@pytest.mark.parametrize("seed", SEEDS)
def test_materialize_matches_reference(seed):
    pb, rb, pl, rl = _case(seed)
    got, gerr = _fold_or_error(mvcc._materialize, pb, pl)
    want, werr = _fold_or_error(ref_mvcc._materialize, rb, rl)
    assert gerr == werr
    if want is not None:
        assert_stores_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:8])
def test_materialize_only_and_vocab_match_reference(seed):
    pb, rb, pl, rl = _case(seed)
    vocab = ref_mvcc.fold_vocab(rb, rl)
    np.testing.assert_array_equal(mvcc.fold_vocab(pb, pl), vocab)
    assert mvcc.fold_preds(pb, pl) == ref_mvcc.fold_preds(rb, rl)
    for p in ref_mvcc.fold_preds(rb, rl):
        for vv in (None, vocab):
            want, werr = _fold_or_error(ref_mvcc._materialize, rb, rl,
                                        only={p}, vocab=vv)
            got, gerr = _fold_or_error(mvcc._materialize, pb, pl,
                                       only={p}, vocab=vv)
            assert gerr == werr, p
            if want is not None:
                assert_stores_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_materialize_on_empty_base_and_schema(seed):
    """An empty base (the mutation-path loader's case) and an Alter's
    new schema (rebuild_base)."""
    pb, rb, pl, rl = _case(100 + seed, empty_base=True)
    got, gerr = _fold_or_error(mvcc._materialize, pb, pl)
    want, werr = _fold_or_error(ref_mvcc._materialize, rb, rl)
    assert gerr == werr
    if want is not None:
        assert_stores_equal(got, want)
    pb, rb, pl, rl = _case(200 + seed)
    extra = "friend: [uid] .\nknows: [uid] @reverse .\nnick: string @index(term) @lang .\n"
    ps, rs = pb.schema.clone(), rb.schema.clone()
    ps.update(parse_schema(extra))
    rs.update(ref_parse_schema(extra))
    got, gerr = _fold_or_error(mvcc._materialize, pb, pl, schema=ps)
    want, werr = _fold_or_error(ref_mvcc._materialize, rb, rl, schema=rs)
    assert gerr == werr
    if want is not None:
        assert_stores_equal(got, want)


def _rules_case():
    """One hand-made sequence per rule of the reference's fold."""
    edges = [(1, "friend", 2, {"w": 1.0}), (1, "friend", 3, None),
             (2, "friend", 3, {"since": 2001, "w": 2.0}),
             (3, "knows", 1, {"w": 5.0})]
    values = [(1, "name", "a", "", {"src": "x"}), (2, "name", "b", "", None),
              (1, "nick", "aa", "en", None), (1, "nick", "ab", "fr", None),
              (1, "tags", "t1", "", None), (1, "tags", "t2", "", None),
              (2, "age", 7, "", None)]
    layers = [
        # set before del in one layer: deletes apply first, set survives
        {"edge_sets": [(1, "friend", 4, None)],
         "edge_dels": [(1, "friend", 4)]},
        # a facet-less set keeps the pair's facets; a set with facets
        # replaces them
        {"edge_sets": [(1, "friend", 2, None), (2, "friend", 3, {"w": 9.0})]},
        # star edge delete drops every (s, *) edge and its facets, then a
        # later layer re-adds one without facets
        {"edge_dels": [(1, "friend", None)]},
        {"edge_sets": [(1, "friend", 2, ())]},
        # a value delete ignores the value; a lang delete leaves others
        {"val_dels": [(2, "name", None, ""), (1, "nick", None, "en")]},
        # star value delete clears every language and the value facets
        {"val_dels": [(1, "name", None, "*")],
         "val_sets": [(1, "name", "z", "", None)]},
        # list append against replace
        {"val_sets": [(1, "tags", "t3", "", None), (2, "age", 8, "", None),
                      (1, "tags", "t1", "", None)]},
        # dgraph.type through add_type; an untyped predicate typed by its
        # first value
        {"val_sets": [(3, "dgraph.type", "Person", "", None),
                      (4, "fresh", 5, "", None), (3, "fresh", 6, "", None)]},
        # a delete of an edge to an unknown uid, and vocabulary touches
        {"edge_dels": [(2, "friend", 777)], "touch_uids": [55]},
    ]
    return edges, values, [(10 * (i + 1), m) for i, m in enumerate(layers)]


def test_materialize_rules_by_hand():
    edges, values, raw = _rules_case()
    pb = _build(StoreBuilder, parse_schema, edges, values)
    rb = _build(RefBuilder, ref_parse_schema, edges, values)
    for k in range(1, len(raw) + 1):
        pl = [mvcc._Layer(ts, mvcc.Mutation(**m)) for ts, m in raw[:k]]
        rl = [ref_mvcc._Layer(ts, ref_mvcc.Mutation(**m))
              for ts, m in raw[:k]]
        assert_stores_equal(mvcc._materialize(pb, pl),
                            ref_mvcc._materialize(rb, rl))


@pytest.mark.parametrize("layers", [
    [{"val_sets": [(1, "friend", "x", "", None)]}],
    [{"val_sets": [(1, "friend", "x", "", None)]},
     {"val_dels": [(1, "friend", None, "")]}],
    [{"edge_sets": [(1, "name", 2, None)]}],
    [{"edge_sets": [(1, "age", 2, None)]},
     {"edge_dels": [(1, "age", None)]}],
], ids=["value_on_uid", "value_on_uid_deleted", "edge_on_value",
        "edge_on_value_deleted"])
def test_kind_clashes_match_reference(layers):
    """A value set on a uid predicate, or an edge on a value predicate:
    refused as the reference refuses it, or folded away when a later
    delete empties it."""
    edges, values, _raw = _rules_case()
    pb = _build(StoreBuilder, parse_schema, edges, values)
    rb = _build(RefBuilder, ref_parse_schema, edges, values)
    pl = [mvcc._Layer(10 + i, mvcc.Mutation(**m))
          for i, m in enumerate(layers)]
    rl = [ref_mvcc._Layer(10 + i, ref_mvcc.Mutation(**m))
          for i, m in enumerate(layers)]
    got, gerr = _fold_or_error(mvcc._materialize, pb, pl)
    want, werr = _fold_or_error(ref_mvcc._materialize, rb, rl)
    assert gerr == werr
    if want is not None:
        assert_stores_equal(got, want)


@pytest.mark.parametrize("vocab_grows", [False, True])
def test_alter_reverse_on_untouched_tablet(vocab_grows):
    """An Alter that adds @reverse to an edge tablet no layer touched
    (with and without new uids in the layers)."""
    edges, values, _raw = _rules_case()
    pb = _build(StoreBuilder, parse_schema, edges, values)
    rb = _build(RefBuilder, ref_parse_schema, edges, values)
    raw = [(10, {"val_sets": [(2 if not vocab_grows else 77, "age", 9, "",
                               None)]})]
    extra = "knows: [uid] @reverse .\nfriend: [uid] .\n"
    ps, rs = pb.schema.clone(), rb.schema.clone()
    ps.update(parse_schema(extra))
    rs.update(ref_parse_schema(extra))
    got = mvcc._materialize(pb, [mvcc._Layer(ts, mvcc.Mutation(**m))
                                 for ts, m in raw], schema=ps)
    want = ref_mvcc._materialize(rb, [ref_mvcc._Layer(ts,
                                                      ref_mvcc.Mutation(**m))
                                      for ts, m in raw], schema=rs)
    assert got.preds["knows"].rev is not None
    assert_stores_equal(got, want)


ALTERS = {
    "new_index": "age: int .\nname: string @index(exact) .\n"
                 "score: float @index(float) .\n",
    "index_on_lang": "nick: string @index(term, exact) @lang .\n",
    "list_flags": "tags: string @index(exact) .\ncnt: [int] .\n",
    "retyped": "score: string @index(exact) .\nage: float .\n",
    "typed_untyped": "cnt: int @index(int) .\nnote: string .\n",
}


@pytest.mark.parametrize("layers", [0, 6])
@pytest.mark.parametrize("alter", sorted(ALTERS))
def test_alter_schema_matches_reference(alter, layers):
    """An Alter's rebuild (`_materialize` with a merged schema) over the
    base alone and over pending layers: kind-keeping changes (indexes,
    list and @lang flags) fold on the numpy path, retyped tablets on the
    literal one; both equal the reference."""
    pb, rb, pl, rl = _case(300 + layers + len(alter))
    ps, rs = pb.schema.clone(), rb.schema.clone()
    ps.update(parse_schema(ALTERS[alter]))
    rs.update(ref_parse_schema(ALTERS[alter]))
    got, gerr = _fold_or_error(mvcc._materialize, pb, pl[:layers],
                               schema=ps)
    want, werr = _fold_or_error(ref_mvcc._materialize, rb, rl[:layers],
                                schema=rs)
    assert gerr == werr
    if want is not None:
        assert_stores_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_fast_fold_matches_literal_fold(seed):
    """The numpy fold against the port's own copy of the reference's
    code (`_materialize_literal`) on the same port base."""
    pb, _rb, pl, _rl = _case(seed)
    got, gerr = _fold_or_error(mvcc._materialize, pb, pl)
    want, werr = _fold_or_error(mvcc._materialize_literal, pb, pl)
    assert gerr == werr
    if want is not None:
        assert_stores_equal(got, want)


def test_untouched_tablets_keep_their_arrays():
    """Without vocabulary growth a tablet no layer touched keeps the very
    same CSR arrays (what lets kernel caches carry across a rollup)."""
    edges, values, _raw = _rules_case()
    pb = _build(StoreBuilder, parse_schema, edges, values)
    out = mvcc._materialize(pb, [mvcc._Layer(10, mvcc.Mutation(
        val_sets=[(2, "age", 9, "", None)]))])
    assert out.preds["friend"].fwd is pb.preds["friend"].fwd
    assert out.preds["friend"].rev is pb.preds["friend"].rev
    assert out.preds["knows"].fwd is pb.preds["knows"].fwd
    assert out.preds["age"].vals[""] is not pb.preds["age"].vals[""]


def _drive(store_cls, layer_cls, mut_cls, base, raw):
    """The same MVCCStore program on either package: returns the views
    it read, in order."""
    m = store_cls(base=base, base_ts=1)
    views = []
    half = len(raw) // 2
    for ts, d in raw[:half]:
        m.apply(mut_cls(**d), ts)
    for ts in (1, raw[0][0], raw[half - 1][0]):
        views.append(m.read_view(ts))
    views.append(m.rollup(raw[half // 2][0]))
    for ts, d in raw[half:-1]:
        m.apply(mut_cls(**d), ts)
    views.append(m.read_view(raw[-2][0]))
    views.append(m.read_view(raw[half // 2][0]))
    views.append(m.rollup())
    m.gc(raw[half][0])
    views.append(m.read_view(raw[-2][0]))
    # a straggler below the newest fold point
    m.absorb_straggler(mut_cls(**raw[-1][1]), raw[half][0] + 5)
    views.append(m.read_view(raw[half][0] + 5))
    views.append(m.read_view(10**6))
    assert len(m._views) <= 8
    return views, [l.commit_ts for l in m.layers], m.floor_ts()


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_mvcc_store_matches_reference(seed):
    pb, rb, _pl, _rl = _case(seed)
    raw = _layers(np.random.default_rng(1000 + seed), 10)
    got = _drive(mvcc.MVCCStore, mvcc._Layer, mvcc.Mutation, pb, raw)
    want = _drive(ref_mvcc.MVCCStore, ref_mvcc._Layer, ref_mvcc.Mutation,
                  rb, raw)
    assert got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        assert_stores_equal(g, w)


def test_absorb_straggler_and_drop_match_reference():
    edges, values, raw = _rules_case()
    pb = _build(StoreBuilder, parse_schema, edges, values)
    rb = _build(RefBuilder, ref_parse_schema, edges, values)
    out = []
    for cls, mut in ((mvcc.MVCCStore, mvcc.Mutation),
                     (ref_mvcc.MVCCStore, ref_mvcc.Mutation)):
        m = cls(base=pb if cls is mvcc.MVCCStore else rb, base_ts=1)
        for ts, d in raw[:4]:
            m.apply(mut(**d), ts)
        m.rollup()
        m.drop_predicate("nick", 45)
        m.apply(mut(val_sets=[(1, "nick", "back", "en", None)]), 50)
        m.absorb_straggler(mut(**raw[6][1]), 25)
        out.append([m.read_view(ts) for ts in (15, 26, 46, 60)])
    for g, w in zip(*out):
        assert_stores_equal(g, w)


def _perturb(st, what):
    """Change one array or map of `st` in place (`store_diff`'s cases)."""
    name, knows = st.preds["name"], st.preds["knows"]
    if what == "uids":
        st.uids = st.uids.copy()
        st.uids[-1] += 1
    elif what == "csr":
        knows.fwd.indices = knows.fwd.indices.copy()
        knows.fwd.indices[0] ^= 1
    elif what == "value":
        col = name.vals[""]
        col.vals = col.vals.copy()
        col.vals[0] = "zz"
    elif what == "edge_facet":
        fc = knows.efacets["w"]
        fc.vals = fc.vals.copy()
        fc.vals[0] = -1.0
    elif what == "value_facet":
        m = name.vfacets["src"]
        m[next(iter(m))] = "changed"
    elif what == "token":
        name.index["term"].pop(next(iter(name.index["term"])))
    else:
        inv = name.index["exact"]
        t = next(iter(inv))
        inv[t] = inv[t][:-1] if len(inv[t]) > 1 else inv[t] + 1


@pytest.mark.parametrize("what", ["uids", "csr", "value", "edge_facet",
                                  "value_facet", "token", "postings"])
def test_store_diff_names_each_difference(what):
    """`store_diff` (the chip smoke's tablet-for-tablet gate) finds a
    change in any array or map of two stores built alike, and none
    between the two before the change."""
    from dgraph_tpu_torch.store.store import store_diff
    edges, values = _base_triples(np.random.default_rng(0))
    a = _build(StoreBuilder, parse_schema, edges, values)
    b = _build(StoreBuilder, parse_schema, edges, values)
    assert store_diff(a, b) is None
    _perturb(b, what)
    assert store_diff(b, a) is not None
