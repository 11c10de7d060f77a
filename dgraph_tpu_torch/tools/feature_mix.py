"""The DQL-feature mix over the LDBC SNB graph.

Thirteen query templates that use the DQL features beyond the IC
templates' traversals — aggregates, math(), @groupby, @cascade,
@normalize, regexp/match, fulltext, geo and checkpwd; groupby_tag is
IC4's count of a friend's new posts per tag. The store is
`models/ldbc.SCHEMA` plus three predicates:

    first_name: string @index(exact, term, trigram, fulltext) .
    loc: geo @index(geo) .     one GeoJSON point per person
    pwd: password .            hash_password(f"pw{i}"), first 16 persons

The points are drawn with numpy from seed 10: longitude uniform in
[-10, 30], latitude uniform in [35, 60]. Each scrypt check costs tens
of milliseconds, hence only 16 passwords.

`build_store(g)` builds the port store, `templates(g)` gives the 13
queries with `ic_params(g)`'s person, median timestamp and city, and
`batch(g)` a serving batch of distinct instances of each.
"""

from __future__ import annotations

import json

import numpy as np

from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import Store, StoreBuilder
from dgraph_tpu_torch.store.types import hash_password

SCHEMA_EXT = """
first_name: string @index(exact, term, trigram, fulltext) .
loc: geo @index(geo) .
pwd: password .
"""
LOC_SEED = 10
N_PASSWORDS = 16
BATCH_SEED = 5              # draws the start persons of `batch`

# %(p)s: a person uid; %(ts)d: a creation timestamp; %(c)s: a city;
# %(pw_uid)s / %(pw)s: a person with a password, and that password
TEMPLATES = {
    "agg_minmax": '{ q(func: uid(%(p)s)) { knows { ~has_creator '
                  '{ t as creation_ts } first_post: min(val(t)) '
                  'last_post: max(val(t)) } } }',
    "agg_root": '{ var(func: uid(%(p)s)) { knows { y as birthday_year } } '
                'q() { youngest: max(val(y)) mean: avg(val(y)) '
                'total: sum(val(y)) } }',
    "math": '{ q(func: uid(%(p)s)) { knows { n as count(~has_creator) '
            'y as birthday_year score: math(n * 2 + (2030 - y)) } } }',
    "groupby_tag": '{ q(func: uid(%(p)s)) { knows { ~has_creator '
                   '@filter(ge(creation_ts, %(ts)d)) @groupby(has_tag) '
                   '{ count(uid) } } } }',
    "groupby_root": '{ q(func: eq(city, "%(c)s")) @groupby(birthday_year) '
                    '{ count(uid) } }',
    "cascade": '{ q(func: eq(city, "%(c)s")) @cascade { first_name '
               'works_at @filter(eq(org_name, "org_0")) { org_name } } }',
    "normalize": '{ q(func: uid(%(p)s)) @normalize { n: first_name '
                 'knows (first: 20) { f: first_name c: city } } }',
    "regexp": '{ q(func: regexp(first_name, /^(Ma|So)/)) '
              '@filter(eq(city, "%(c)s")) { first_name } }',
    "match": '{ q(func: match(first_name, "Marla", 2)) '
             '@filter(eq(city, "%(c)s")) { first_name } }',
    "text": '{ q(func: anyoftext(first_name, "yangs kenji")) '
            '@filter(eq(city, "%(c)s")) { first_name } }',
    "near": '{ q(func: near(loc, [10.0, 50.0], 200000)) '
            '{ first_name loc } }',
    "within": '{ q(func: within(loc, [[[0.0, 45.0], [5.0, 45.0], '
              '[5.0, 50.0], [0.0, 50.0], [0.0, 45.0]]])) { count(uid) } }',
    "checkpwd": '{ q(func: uid(%(pw_uid)s)) { first_name '
                'checkpwd(pwd, "%(pw)s") } }',
}
NAMES = tuple(TEMPLATES)


def extension_values(g: ldbc.SNBGraph) -> list[tuple[int, str, object]]:
    """(uid, predicate, value) of the `loc` and `pwd` values. The
    password hashes are salted at random: pass one list to every store
    that must hold the same values."""
    rng = np.random.default_rng(LOC_SEED)
    n = len(g.person_uids)
    lon = rng.uniform(-10.0, 30.0, n)
    lat = rng.uniform(35.0, 60.0, n)
    out: list[tuple[int, str, object]] = [
        (u, "loc", json.dumps({"type": "Point",
                               "coordinates": [float(x), float(y)]}))
        for u, x, y in zip(g.person_uids.tolist(), lon, lat)]
    out += [(u, "pwd", hash_password(f"pw{i}"))
            for i, u in enumerate(g.person_uids[:N_PASSWORDS].tolist())]
    return out


def load_into(builder: StoreBuilder, g: ldbc.SNBGraph,
              ext: list | None = None) -> None:
    """`models/ldbc.load_into` plus the schema extension and its values
    (`ext`, default `extension_values(g)`)."""
    ldbc.load_into(builder, g)
    builder.schema.update(parse_schema(SCHEMA_EXT))
    for uid, pred, value in (extension_values(g) if ext is None else ext):
        builder.add_value(uid, pred, value)


def build_store(g: ldbc.SNBGraph, ext: list | None = None) -> Store:
    b = StoreBuilder()
    load_into(b, g, ext)
    return b.finalize()


def _params(g: ldbc.SNBGraph, person: int, city: str, pw_index: int):
    return {"p": hex(person), "ts": ldbc.ic_params(g)["ts_mid"], "c": city,
            "pw_uid": hex(int(g.person_uids[pw_index])),
            "pw": f"pw{pw_index}"}


def templates(g: ldbc.SNBGraph) -> dict[str, str]:
    """The 13 templates with `ic_params(g)`'s person (P), median
    timestamp (TS) and city (C); checkpwd asks for the first person's
    password."""
    pr = ldbc.ic_params(g)
    params = _params(g, pr["p"], pr["city"], 0)
    return {name: t % params for name, t in TEMPLATES.items()}


def batch(g: ldbc.SNBGraph, copies: int = 8) -> list[tuple[str, str]]:
    """A serving batch: `copies` instances of each template, interleaved
    template by template, as (template name, DQL) pairs. Instance c takes
    a distinct start person drawn with numpy from BATCH_SEED (the uid(P)
    templates), city c of `models/ldbc.CITIES` in turn (the city
    templates) and the password of person c (checkpwd)."""
    rng = np.random.default_rng(BATCH_SEED)
    persons = rng.choice(g.person_uids, size=copies, replace=False)
    out = []
    for c in range(copies):
        params = _params(g, int(persons[c]),
                         ldbc.CITIES[c % len(ldbc.CITIES)], c % N_PASSWORDS)
        out += [(name, t % params) for name, t in TEMPLATES.items()]
    return out
