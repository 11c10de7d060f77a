"""Port Engine == the JAX package's Engine, byte for byte.

A small hand-built store (people with names, ages, cities, tags, a
`friend` graph with facets, typed nodes, value facets, language tags) is
loaded through the reference Alpha's mutation path and carried into the
port with store_from_arrays. Every query runs through the reference
Engine and through the port Engine on the CPU twice: with
device_threshold 0 (every non-empty frontier through the torch ops) and
10**9 (the host walk). The compact JSON must be identical.
"""

import json

import numpy as np
import pytest
import torch

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.server.api import Alpha
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.store.store import store_from_arrays

CPU = "cpu"
torch.set_num_threads(1)
N = 60
SCHEMA = """
name: string @index(exact, term) @lang .
age: int @index(int) .
city: string @index(exact) .
tags: [string] @index(term) .
friend: [uid] @reverse @count .
boss: [uid] @reverse .
type Person {
  name
  age
  friend
}
"""


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(17)
    a = Alpha(device_threshold=10**9)
    a.alter(SCHEMA)
    cities = ["Oslo", "Lima", "Pune"]
    words = ["red fish", "blue fish", "red boat", "green tree"]
    lines = []
    for i in range(N):
        lines.append(f'_:p{i} <name> "person {i % 17}" (q={i % 5}) .')
        if i % 4 == 0:
            lines.append(f'_:p{i} <name> "persona {i}"@es .')
        if i % 7:
            lines.append(f'_:p{i} <age> "{18 + (i * 7) % 50}"^^<xs:int> .')
        lines.append(f'_:p{i} <city> "{cities[i % 3]}" .')
        lines.append(f'_:p{i} <tags> "{words[i % 4]}" .')
        if i % 3 == 0:
            lines.append(f'_:p{i} <dgraph.type> "Person" .')
        for j in rng.choice(N, 3, replace=False).tolist():
            if j != i:
                w = round(float(rng.uniform(0.5, 9.5)), 2)
                lines.append(f'_:p{i} <friend> _:p{j} '
                             f'(weight={w}, since={2000 + j % 20}) .')
        if i % 5:
            lines.append(f'_:p{i} <boss> _:p{i - i % 5} .')
    a.mutate(set_nquads="\n".join(lines))
    ref = a.mvcc.read_view(a.oracle.read_only_ts())
    return ref, store_from_arrays(ref)


def _uid(store, rank):
    return hex(int(store.uids[rank]))


def queries(ref):
    u0, u1, u7 = _uid(ref, 0), _uid(ref, 1), _uid(ref, 7)
    return {
        "uid_leaves": '{ q(func: uid(%s, %s)) { uid name age city '
                      'count(friend) friend { name } } }' % (u0, u1),
        "filter_and_or_not":
            '{ q(func: has(name)) @filter((ge(age, 30) AND NOT '
            'eq(city, "Lima")) OR le(age, 20)) { name age city } }',
        "child_filters":
            '{ q(func: has(friend), first: 25) { uid friend '
            '@filter(ge(age, 25) AND (eq(city, "Oslo") OR eq(city, "Pune")))'
            ' { name age } } }',
        "child_not_filter":
            '{ q(func: has(friend), first: 25) { uid friend '
            '@filter(NOT le(age, 40)) { uid } } }',
        "order_root":
            '{ q(func: has(age), orderdesc: age, orderasc: name, first: 12,'
            ' offset: 3) { name age } }',
        "order_child":
            '{ q(func: has(friend), first: 20) { name friend '
            '(orderasc: age, first: 2) { name age } } }',
        "order_child_desc":
            '{ q(func: has(friend)) { friend (orderdesc: name, offset: 1) '
            '{ name } } }',
        "first_negative":
            '{ q(func: has(friend), first: 30) { uid friend (first: -1) '
            '{ uid } } }',
        "after":
            '{ q(func: has(name), first: 5, after: %s) { uid name } }' % u7,
        "child_after":
            '{ q(func: has(friend), first: 15) { friend (after: %s) '
            '{ uid } } }' % u7,
        "reverse": '{ q(func: has(name), first: 30) { name ~friend '
                   '{ name ~boss { uid } } } }',
        "nested_3": '{ q(func: uid(%s)) { friend { friend { friend '
                    '{ uid name } } } } }' % u1,
        "uid_var": '{ var(func: uid(%s)) { f as friend } '
                   'q(func: uid(f), orderasc: age) { name age } }' % u0,
        "val_var": '{ var(func: has(age)) { a as age } '
                   'q(func: uid(a), first: 8, orderdesc: val(a)) '
                   '{ name val(a) } }',
        "val_var_filter": '{ var(func: has(age)) { a as age } '
                          'q(func: has(name)) @filter(gt(val(a), 50)) '
                          '{ name } }',
        "count_var": '{ var(func: has(friend)) { c as count(friend) } '
                     'q(func: uid(c)) @filter(ge(val(c), 3)) '
                     '{ name val(c) } }',
        "count_compare": '{ q(func: ge(count(friend), 3)) { uid } }',
        "expand_all": '{ q(func: type(Person), first: 6) { expand(_all_) '
                      '{ uid } } }',
        "expand_type": '{ q(func: uid(%s)) { expand(Person) } }' % u0,
        "recurse_loop_false": '{ q(func: uid(%s)) @recurse(depth: 4, '
                              'loop: false) { name friend } }' % u0,
        "recurse_loop_true": '{ q(func: uid(%s)) @recurse(depth: 3, '
                             'loop: true) { uid friend } }' % u1,
        "recurse_filter": '{ q(func: uid(%s, %s)) @recurse(depth: 3) '
                          '{ name friend @filter(ge(age, 30)) ~boss } }'
                          % (u0, u7),
        "facets_all": '{ q(func: has(friend), first: 10) { name friend '
                      '@facets { name } } }',
        "facets_alias": '{ q(func: has(friend), first: 10) { friend '
                        '@facets(w: weight) { uid } } }',
        "facets_filter": '{ q(func: has(friend)) { friend '
                         '@facets(gt(weight, 5.0)) { uid } } }',
        "facets_order": '{ q(func: has(friend), first: 10) { friend '
                        '@facets(orderdesc: weight) { uid } } }',
        "facets_reverse": '{ q(func: has(name), first: 12) { ~friend '
                          '@facets(since) { uid } } }',
        "facet_var": '{ var(func: uid(%s)) { friend @facets(w as weight) }'
                     ' q(func: uid(w), orderasc: val(w)) { name val(w) } }'
                     % u0,
        "value_facets": '{ q(func: uid(%s, %s)) { name @facets } }'
                        % (u0, u7),
        "has_uid_in": '{ q(func: uid_in(friend, %s)) { name } '
                      'r(func: has(~boss)) { uid } }' % u1,
        "terms": '{ a(func: anyofterms(tags, "red boat")) { uid tags } '
                 'b(func: allofterms(tags, "red fish")) { uid } '
                 'c(func: anyofterms(name, "person 3")) { uid } }',
        "lang": '{ q(func: has(name), first: 9) { name@es name@es:. '
                'name@* } }',
        "count_uid": '{ q(func: has(friend)) { count(uid) friend '
                     '{ count(uid) } } }',
        "shortest": '{ p as shortest(from: %s, to: %s) { friend } '
                    'q(func: uid(p)) { name } }' % (u0, u7),
        "shortest_k": '{ shortest(from: %s, to: %s, numpaths: 3) '
                      '{ friend ~boss } }' % (u1, u7),
        "shortest_weighted": '{ shortest(from: %s, to: %s, numpaths: 2) '
                             '{ friend @facets(weight) } }' % (u0, u7),
        "schema": 'schema { type index }',
        "regexp": '{ q(func: regexp(name, /per/)) @filter(eq(city, "Oslo"))'
                  ' { uid name } }',
        "math": '{ q(func: has(age), first: 10) { a as age '
                'm: math(a * 2 + 1) friend { n as count(friend) '
                's: math(n + a) } } }',
        "normalize": '{ q(func: has(age), first: 10) @normalize { a: age '
                     'friend { n: name c: city } } }',
        "cascade": '{ q(func: has(name), first: 20) @cascade { name age '
                   'friend @filter(ge(age, 40)) { name } } }',
        "groupby": '{ q(func: has(friend), first: 12) { city friend '
                   '@groupby(city) { count(uid) } } '
                   'g(func: has(age)) @groupby(city) { count(uid) } }',
        "aggregates": '{ var(func: has(age)) { a as age } '
                      'q(func: has(friend), first: 8) { friend '
                      '{ lo: min(val(a)) hi: max(val(a)) s: sum(val(a)) } } '
                      'r() { mean: avg(val(a)) } }',
    }


NAMES = [
    "uid_leaves", "filter_and_or_not", "child_filters", "child_not_filter",
    "order_root", "order_child", "order_child_desc", "first_negative",
    "after", "child_after", "reverse", "nested_3", "uid_var", "val_var",
    "val_var_filter", "count_var", "count_compare", "expand_all",
    "expand_type", "recurse_loop_false", "recurse_loop_true",
    "recurse_filter", "facets_all", "facets_alias", "facets_filter",
    "facets_order", "facets_reverse", "facet_var", "value_facets",
    "has_uid_in", "terms", "lang", "count_uid", "shortest", "shortest_k",
    "shortest_weighted", "schema", "regexp", "math", "normalize", "cascade",
    "groupby", "aggregates"]


@pytest.mark.parametrize("threshold", [0, 10**9])
@pytest.mark.parametrize("name", NAMES)
def test_query_equals_reference(stores, name, threshold):
    ref, port = stores
    q = queries(ref)[name]
    want = json.dumps(RefEngine(ref, device_threshold=10**9).query(q),
                      separators=(",", ":")).encode()
    eng = Engine(port, device=CPU, device_threshold=threshold)
    got = eng.query_bytes(q)
    assert got == want
    if threshold == 0 and name != "schema":
        # every expansion with work went through the torch ops
        assert eng.routes.expansions["numpy"] == 0


def test_routes_take_the_device_at_threshold_zero(stores, monkeypatch):
    ref, port = stores
    eng = Engine(port, device=CPU, device_threshold=0)
    eng.query(queries(ref)["child_filters"])
    # the block is one whole-block program (engine/fused.py) ...
    assert eng.routes.expansions["program"] >= 1
    assert eng.routes.expansions["fused"] == 0
    # ... and with whole-block programs off, its level is expand_level
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "0")
    eng.query(queries(ref)["child_filters"])
    assert eng.routes.expansions["fused"] >= 1
    eng.query(queries(ref)["order_child"])
    assert eng.routes.expansions["device"] >= 1
    host = Engine(port, device=CPU, device_threshold=10**9)
    host.query(queries(ref)["order_child"])
    assert host.routes.on_device() == 0 and host.routes.expansions["numpy"]


def test_engine_without_card_raises(stores, monkeypatch):
    _ref, port = stores
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(port)
    Engine(port, device=CPU)


@pytest.mark.parametrize("q,exc", [
    ('{ q(func: similar_to(name, 2, "[1, 1]")) { uid } }', None),
    ('{ q(func: has(age)) @msgpass(pred: age) { uid friend } }',
     "not a float32vector predicate"),
    ('{ q(func: has(age)) { uid } }', None),
])
def test_unported_features_raise(stores, q, exc):
    """similar_to and @msgpass answer as the reference does on the same
    query: similar_to on a string predicate serves the empty set, and
    @msgpass over an int predicate is refused."""
    ref, port = stores
    eng = Engine(port, device=CPU, device_threshold=0)
    ref_eng = RefEngine(ref, device_threshold=0)
    if exc is None:
        assert eng.query(q) == ref_eng.query(q)
    else:
        with pytest.raises(ValueError, match=exc):
            ref_eng.query(q)
        with pytest.raises(ValueError, match=exc):
            eng.query(q)
