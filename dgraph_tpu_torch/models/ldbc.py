"""LDBC SNB-shaped dataset generator (benchmark + golden-test fixture).

The port's own copy of `dgraph_tpu/models/ldbc.py`: `SNBGraph`,
`generate`, `SCHEMA`, `ic_params` and `ic_templates` are the same code
(the same seed gives the same arrays). `load_into` fills the port's
`StoreBuilder`; `load_into_alpha` is the reference's `load_into`, which
commits the graph through an `Alpha`'s mutation path.

The repo's headline LDBC configs run over Social Network Benchmark data —
persons linked by `knows`, authoring posts/comments in forums, tagged with
topics. The real SNB datagen (Hadoop/Spark) and its datasets are not
available in this environment (zero egress), so this module generates a
deterministic graph with the same *shape*: SF-scaled entity counts, a
community-clustered heavy-tailed `knows` graph, activity (posts/comments)
with creator/reply/tag edges, and typed scalar properties — enough for the
IC-style query mix in bench_baseline.py to be structurally honest.

Scale factors follow SNB's published SF1 proportions (~10k persons, ~180k
knows half-edges, ~1M messages at SF1), scaled linearly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FIRST_NAMES = ["Jan", "Yang", "Arjun", "Maria", "Chen", "Otto", "Abebe",
               "Sofia", "Kenji", "Amara", "Ivan", "Lucia", "Wei", "Noor",
               "Pavel", "Aiko"]
LAST_NAMES = ["Kov", "Li", "Sharma", "Garcia", "Wang", "Muller", "Bekele",
              "Rossi", "Sato", "Okafor", "Petrov", "Silva", "Zhang",
              "Hassan", "Novak", "Tanaka"]
CITIES = ["Beijing", "Mumbai", "Lagos", "Moscow", "Sao_Paulo", "Tokyo",
          "Berlin", "Nairobi", "Lima", "Hanoi", "Tbilisi", "Porto"]
TAG_NAMES = [f"tag_{i}" for i in range(128)]


@dataclass
class SNBGraph:
    """Generated graph in rank-free uid space (uids dense from 1)."""
    n_persons: int
    n_posts: int
    n_comments: int
    n_tags: int
    n_forums: int
    n_orgs: int
    # entity uid ranges: [lo, hi) half-open
    person_uids: np.ndarray
    post_uids: np.ndarray
    comment_uids: np.ndarray
    tag_uids: np.ndarray
    forum_uids: np.ndarray
    org_uids: np.ndarray
    # edges as (src_uid, dst_uid) int64 pairs
    knows: np.ndarray          # person -> person (symmetric pairs both ways)
    knows_weight: np.ndarray   # per knows edge, float (IC14 path weights)
    has_creator: np.ndarray    # message -> person
    reply_of: np.ndarray       # comment -> post|comment
    has_tag: np.ndarray        # message -> tag
    has_member: np.ndarray     # forum -> person
    container_of: np.ndarray   # forum -> post
    likes: np.ndarray          # person -> message
    works_at: np.ndarray       # person -> org
    # properties
    first_name: list           # per person
    last_name: list
    city: list
    birthday_year: np.ndarray  # per person int
    creation_ts: np.ndarray    # per message int (unix-ish)

    @property
    def n_nodes(self) -> int:
        return (self.n_persons + self.n_posts + self.n_comments
                + self.n_tags + self.n_forums + self.n_orgs)

    @property
    def n_edges(self) -> int:
        return (len(self.knows) + len(self.has_creator)
                + len(self.reply_of) + len(self.has_tag)
                + len(self.has_member) + len(self.container_of)
                + len(self.likes) + len(self.works_at))


def generate(sf: float = 0.1, seed: int = 9) -> SNBGraph:
    """SF-scaled SNB-shaped graph. sf=1.0 ≈ 10k persons / ~1M messages
    (the published SF1 proportions); sf=0.1 is the test/CI size."""
    rng = np.random.default_rng(seed)
    n_persons = max(int(9892 * sf), 64)
    n_posts = max(int(400_000 * sf), 256)
    n_comments = max(int(600_000 * sf), 256)
    n_tags = min(len(TAG_NAMES), max(int(16_080 * sf), 16))
    n_forums = max(int(20_000 * sf), 32)
    n_orgs = max(int(1_575 * sf), 8)

    uid = 1
    person_uids = np.arange(uid, uid + n_persons, dtype=np.int64)
    uid += n_persons
    post_uids = np.arange(uid, uid + n_posts, dtype=np.int64)
    uid += n_posts
    comment_uids = np.arange(uid, uid + n_comments, dtype=np.int64)
    uid += n_comments
    tag_uids = np.arange(uid, uid + n_tags, dtype=np.int64)
    uid += n_tags
    forum_uids = np.arange(uid, uid + n_forums, dtype=np.int64)
    uid += n_forums
    org_uids = np.arange(uid, uid + n_orgs, dtype=np.int64)

    # -- knows: community-clustered heavy tail ------------------------------
    # persons sit in sqrt(n)-sized communities; ~80% of friendships are
    # intra-community, the rest global with hub skew — the SNB datagen's
    # "university/city cluster + long-range" structure without its pipeline
    n_comm = max(int(np.sqrt(n_persons)), 4)
    comm = rng.integers(0, n_comm, n_persons)
    deg = np.minimum(rng.zipf(2.2, n_persons), 512)
    deg = np.maximum((deg * (18.0 / max(deg.mean(), 1e-9))).astype(np.int64),
                     1)
    src = np.repeat(np.arange(n_persons), deg)
    local = rng.random(len(src)) < 0.8
    dst = np.empty(len(src), np.int64)
    # intra-community picks: random member of the source's community
    order = np.argsort(comm, kind="stable")
    bounds = np.searchsorted(comm[order], np.arange(n_comm + 1))
    csrc = comm[src[local]]
    lo, hi = bounds[csrc], bounds[csrc + 1]
    dst[local] = order[lo + (rng.random(local.sum())
                             * np.maximum(hi - lo, 1)).astype(np.int64)]
    # long-range picks: hub-skewed
    n_far = int((~local).sum())
    dst[~local] = (n_persons * rng.beta(0.7, 2.0, n_far)).astype(np.int64)
    keep = src != dst
    s, d = src[keep], dst[keep]
    knows = np.stack([np.concatenate([s, d]), np.concatenate([d, s])],
                     axis=1)
    knows = np.unique(knows, axis=0)
    knows = np.stack([person_uids[knows[:, 0]], person_uids[knows[:, 1]]],
                     axis=1)

    # -- activity -----------------------------------------------------------
    # post/comment authorship follows the same heavy tail as friendships
    author_w = deg.astype(np.float64) / deg.sum()
    post_author = rng.choice(n_persons, n_posts, p=author_w)
    comment_author = rng.choice(n_persons, n_comments, p=author_w)
    has_creator = np.stack([
        np.concatenate([post_uids, comment_uids]),
        person_uids[np.concatenate([post_author, comment_author])]], axis=1)

    # comments reply to posts (70%) or earlier comments (30%)
    to_post = rng.random(n_comments) < 0.7
    parent = np.empty(n_comments, np.int64)
    parent[to_post] = post_uids[rng.integers(0, n_posts, to_post.sum())]
    idx = np.arange(n_comments)[~to_post]
    earlier = np.maximum(idx, 1)
    parent[~to_post] = comment_uids[(rng.random(len(idx))
                                     * earlier).astype(np.int64)]
    reply_of = np.stack([comment_uids, parent], axis=1)

    # tags: zipf topic popularity, 0-3 tags per message
    n_msgs = n_posts + n_comments
    tag_cnt = rng.integers(0, 4, n_msgs)
    msg_uids = np.concatenate([post_uids, comment_uids])
    tsrc = np.repeat(msg_uids, tag_cnt)
    tpick = np.minimum(rng.zipf(1.8, len(tsrc)) - 1, n_tags - 1)
    has_tag = np.stack([tsrc, tag_uids[tpick]], axis=1)

    # -- forums, likes, organisations (IC5/7/10/11/14 coverage) -------------
    # forum membership: zipf forum popularity, ~10 members each on average
    m_cnt = np.minimum(rng.zipf(1.9, n_forums) + 4, 256)
    fsrc = np.repeat(np.arange(n_forums), m_cnt)
    fmem = rng.choice(n_persons, len(fsrc), p=author_w)
    has_member = np.unique(np.stack(
        [forum_uids[fsrc], person_uids[fmem]], axis=1), axis=0)
    # every post lives in one forum
    container_of = np.stack(
        [forum_uids[rng.integers(0, n_forums, n_posts)], post_uids],
        axis=1)
    # likes: heavy-tailed fan activity over messages
    n_likes = max(int(600_000 * sf), 512)
    lik_p = rng.choice(n_persons, n_likes, p=author_w)
    lik_m = rng.integers(0, n_msgs, n_likes)
    likes = np.unique(np.stack(
        [person_uids[lik_p], msg_uids[lik_m]], axis=1), axis=0)
    # employment: one org per person, zipf org sizes
    org_of = np.minimum(rng.zipf(1.6, n_persons) - 1, n_orgs - 1)
    works_at = np.stack([person_uids, org_uids[org_of]], axis=1)
    # interaction weight per knows edge (IC14's weighted paths) —
    # symmetric per person-pair: both directed rows of a friendship
    # carry the same weight (SNB defines it per pair)
    pair_lo = np.minimum(knows[:, 0], knows[:, 1])
    pair_hi = np.maximum(knows[:, 0], knows[:, 1])
    pair_key = pair_lo * (knows.max() + 1) + pair_hi
    uniq_pairs, inverse = np.unique(pair_key, return_inverse=True)
    pair_w = np.round(rng.uniform(0.5, 10.0, len(uniq_pairs)), 2)
    knows_weight = pair_w[inverse]

    first = [FIRST_NAMES[i % len(FIRST_NAMES)] for i in
             rng.integers(0, len(FIRST_NAMES), n_persons)]
    last = [LAST_NAMES[i % len(LAST_NAMES)] for i in
            rng.integers(0, len(LAST_NAMES), n_persons)]
    city = [CITIES[i % len(CITIES)] for i in
            rng.integers(0, len(CITIES), n_persons)]
    birthday = rng.integers(1950, 2005, n_persons)
    creation = np.sort(rng.integers(1_262_304_000, 1_356_998_400, n_msgs))

    return SNBGraph(
        n_persons=n_persons, n_posts=n_posts, n_comments=n_comments,
        n_tags=n_tags, n_forums=n_forums, n_orgs=n_orgs,
        person_uids=person_uids, post_uids=post_uids,
        comment_uids=comment_uids, tag_uids=tag_uids,
        forum_uids=forum_uids, org_uids=org_uids, knows=knows,
        knows_weight=knows_weight, has_creator=has_creator,
        reply_of=reply_of, has_tag=has_tag, has_member=has_member,
        container_of=container_of, likes=likes, works_at=works_at,
        first_name=first, last_name=last, city=city,
        birthday_year=birthday, creation_ts=creation)


SCHEMA = """
first_name: string @index(exact, term) .
last_name: string @index(exact) .
city: string @index(exact) .
birthday_year: int @index(int) .
creation_ts: int @index(int) .
tag_name: string @index(exact) .
forum_title: string @index(exact) .
org_name: string @index(exact) .
knows: [uid] @reverse .
has_creator: [uid] @reverse .
reply_of: [uid] @reverse .
has_tag: [uid] @reverse .
has_member: [uid] @reverse .
container_of: [uid] @reverse .
likes: [uid] @reverse .
works_at: [uid] @reverse .
"""


def ic_params(g: SNBGraph) -> dict:
    """Concrete parameter choices for the IC templates."""
    return {
        "p": int(g.person_uids[len(g.person_uids) // 2]),
        "p2": int(g.person_uids[7]),
        "fn": g.first_name[3],
        "city": g.city[0], "city2": g.city[1],
        "ts_mid": int(np.median(g.creation_ts)),
    }


def ic_templates(g: SNBGraph) -> dict[str, str]:
    """All 14 LDBC SNB Interactive Complex template shapes as DQL."""
    pr = ic_params(g)
    p_uid = hex(pr["p"])
    p2_uid = hex(pr["p2"])
    fn = pr["fn"]
    city, city2 = pr["city"], pr["city2"]
    ts_mid = pr["ts_mid"]
    return {
        "IC1": '{ v as var(func: uid(%s)) @recurse(depth: 3, '
               'loop: false) { knows } '
               'q(func: uid(v), orderasc: last_name, first: 20) '
               '@filter(eq(first_name, "%s")) '
               '{ first_name last_name city } }' % (p_uid, fn),
        "IC2": '{ q(func: uid(%s)) { knows { ~has_creator '
               '(orderdesc: creation_ts, first: 20) '
               '{ creation_ts } } } }' % p_uid,
        "IC3": '{ q(func: uid(%s)) { knows { knows '
               '@filter(eq(city, "%s") OR eq(city, "%s")) '
               '{ first_name last_name city } } } }'
               % (p_uid, city, city2),
        "IC4": '{ q(func: uid(%s)) { knows { ~has_creator (first: 20) '
               '@filter(ge(creation_ts, %d)) '
               '{ has_tag { tag_name } } } } }' % (p_uid, ts_mid),
        "IC5": '{ q(func: uid(%s)) { knows { ~has_member '
               '(orderasc: forum_title, first: 20) '
               '{ forum_title } } } }' % p_uid,
        "IC6": '{ t(func: eq(tag_name, "tag_1")) { ~has_tag (first: 50)'
               ' { has_tag { tag_name } } } }',
        "IC7": '{ q(func: uid(%s)) { ~has_creator { ~likes (first: 20) '
               '{ first_name } } } }' % p_uid,
        "IC8": '{ q(func: uid(%s)) { ~has_creator { ~reply_of '
               '(orderdesc: creation_ts, first: 20) { creation_ts '
               'has_creator { first_name } } } } }' % p_uid,
        "IC9": '{ var(func: uid(%s)) { knows { f as knows } } '
               'q(func: uid(f)) { ~has_creator (first: 20) '
               '@filter(le(creation_ts, %d)) '
               '{ creation_ts } } }' % (p_uid, ts_mid),
        "IC10": '{ q(func: uid(%s)) { knows { knows (first: 10) '
                '@filter(ge(birthday_year, 1985)) '
                '{ first_name city } } } }' % p_uid,
        "IC11": '{ q(func: uid(%s)) { knows { works_at '
                '@filter(eq(org_name, "org_0")) { org_name } } } }'
                % p_uid,
        "IC12": '{ q(func: uid(%s)) { knows { ~has_creator (first: 20) '
                '@filter(has(reply_of)) { reply_of '
                '{ has_tag { tag_name } } } } } }' % p_uid,
        "IC13": '{ path as shortest(from: %s, to: %s) { knows } '
                'p(func: uid(path)) { first_name } }' % (p_uid, p2_uid),
        "IC14": '{ path as shortest(from: %s, to: %s, numpaths: 2) '
                '{ knows @facets(weight) } }' % (p_uid, p2_uid),
    }


def ic_batch(g: SNBGraph, copies: int = 32, seed: int = 0,
             ic14_copies: int | None = None) -> list[tuple[str, str]]:
    """A mixed serving batch: `copies` instances of each of IC1-IC13 and
    config 3, and `ic14_copies` (default `copies`) of IC14, interleaved
    template by template, as (template name, DQL) pairs.

    Instance c of a template takes a distinct start person drawn with
    numpy from `seed` in place of `ic_params`' person (IC13/IC14 also a
    distinct target person, never the start); IC6, which starts from a
    tag, takes a distinct tag, and config 3 a city in turn."""
    import re

    rng = np.random.default_rng(seed)
    pr = ic_params(g)
    templates = ic_templates(g)
    templates["config3"] = config3_query(g)
    persons = rng.choice(g.person_uids, size=copies, replace=False)
    targets = rng.choice(g.person_uids, size=copies, replace=False)
    targets = np.where(targets == persons, np.roll(targets, 1), targets)
    tags = rng.choice(len(TAG_NAMES), size=copies,
                      replace=copies > len(TAG_NAMES))
    n14 = copies if ic14_copies is None else ic14_copies

    out = []
    for c in range(copies):
        uids = {hex(pr["p"]): hex(int(persons[c])),
                hex(pr["p2"]): hex(int(targets[c]))}
        for name, q in templates.items():
            if name == "IC14" and c >= n14:
                continue
            if name == "IC6":
                q = q.replace('"tag_1"', '"%s"' % TAG_NAMES[tags[c]])
            elif name == "config3":
                q = q.replace('"%s"' % g.city[0],
                              '"%s"' % CITIES[c % len(CITIES)])
            else:
                q = re.sub(r"\b0x[0-9a-f]+\b",
                           lambda m: uids.get(m.group(0), m.group(0)), q)
            out.append((name, q))
    return out


def config3_query(g: SNBGraph) -> str:
    """The 3-hop filtered `@recurse` from every person of one city
    (the repo's LDBC config 3)."""
    return ('{ q(func: eq(city, "%s")) @recurse(depth: 3, loop: false) '
            '{ uid knows @filter(ge(birthday_year, 1980)) } }' % g.city[0])


def load_into(builder, g: SNBGraph) -> None:
    """Install the graph into a port `StoreBuilder`: the schema, every
    edge predicate (the `knows` interaction weights as `weight` edge
    facets) and every scalar property, in the reference loader's order."""
    from dgraph_tpu_torch.store.schema import parse_schema

    builder.schema.update(parse_schema(SCHEMA))
    for (s, o), w in zip(g.knows.tolist(), g.knows_weight.tolist()):
        builder.add_edge(s, "knows", o, facets={"weight": float(w)})
    for pred in ("has_creator", "reply_of", "has_tag", "has_member",
                 "container_of", "likes", "works_at"):
        pairs = getattr(g, pred)
        builder.add_edges(pred, pairs[:, 0], pairs[:, 1])
    for i, u in enumerate(g.person_uids.tolist()):
        builder.add_value(u, "first_name", g.first_name[i])
        builder.add_value(u, "last_name", g.last_name[i])
        builder.add_value(u, "city", g.city[i])
        builder.add_value(u, "birthday_year", int(g.birthday_year[i]))
    msg_uids = np.concatenate([g.post_uids, g.comment_uids])
    for u, ts in zip(msg_uids.tolist(), g.creation_ts.tolist()):
        builder.add_value(u, "creation_ts", int(ts))
    for i, u in enumerate(g.tag_uids.tolist()):
        builder.add_value(u, "tag_name", TAG_NAMES[i])
    for i, u in enumerate(g.forum_uids.tolist()):
        builder.add_value(u, "forum_title", f"forum_{i}")
    for i, u in enumerate(g.org_uids.tolist()):
        builder.add_value(u, "org_name", f"org_{i}")


def load_into_alpha(alpha, g: SNBGraph, batch: int = 200_000) -> None:
    """Install the graph through an `Alpha`'s mutation path in committed
    batches (the reference's `load_into(alpha, g)`): the schema by
    Alter, then each edge predicate, the person values, the message
    timestamps and the names of tags, forums and organisations."""
    def commit_edges(pred, pairs):
        for i in range(0, len(pairs), batch):
            txn = alpha.new_txn()
            for s, o in pairs[i:i + batch]:
                txn.mutation.edge_sets.append((int(s), pred, int(o), ()))
            txn.commit()

    def commit_weighted(pred, pairs, weights):
        for i in range(0, len(pairs), batch):
            txn = alpha.new_txn()
            for (s, o), w in zip(pairs[i:i + batch],
                                 weights[i:i + batch]):
                txn.mutation.edge_sets.append(
                    (int(s), pred, int(o), {"weight": float(w)}))
            txn.commit()

    alpha.alter(SCHEMA)
    commit_weighted("knows", g.knows, g.knows_weight)
    for pred in ("has_creator", "reply_of", "has_tag", "has_member",
                 "container_of", "likes", "works_at"):
        commit_edges(pred, getattr(g, pred))
    txn = alpha.new_txn()
    for i, uid in enumerate(g.person_uids):
        u = int(uid)
        txn.mutation.val_sets.append((u, "first_name", g.first_name[i],
                                      "", ()))
        txn.mutation.val_sets.append((u, "last_name", g.last_name[i],
                                      "", ()))
        txn.mutation.val_sets.append((u, "city", g.city[i], "", ()))
        txn.mutation.val_sets.append((u, "birthday_year",
                                      int(g.birthday_year[i]), "", ()))
    txn.commit()
    msg_uids = np.concatenate([g.post_uids, g.comment_uids])
    for i in range(0, len(msg_uids), batch):
        txn = alpha.new_txn()
        for j in range(i, min(i + batch, len(msg_uids))):
            txn.mutation.val_sets.append(
                (int(msg_uids[j]), "creation_ts", int(g.creation_ts[j]),
                 "", ()))
        txn.commit()
    txn = alpha.new_txn()
    for i, uid in enumerate(g.tag_uids):
        txn.mutation.val_sets.append((int(uid), "tag_name", TAG_NAMES[i],
                                      "", ()))
    for i, uid in enumerate(g.forum_uids):
        txn.mutation.val_sets.append((int(uid), "forum_title",
                                      f"forum_{i}", "", ()))
    for i, uid in enumerate(g.org_uids):
        txn.mutation.val_sets.append((int(uid), "org_name",
                                      f"org_{i}", "", ()))
    txn.commit()
