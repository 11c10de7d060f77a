"""LDBC SNB-shaped data at a scale factor, and GraphRAG embeddings.

`generate` is a frozen copy of `dgraph_tpu_torch/models/ldbc.py`'s
generator (the official SNB Datagen is not available here): SF-scaled
entity counts in SNB Interactive's SF1 proportions (9,892 persons,
400,000 posts, 600,000 comments at SF1), a community-clustered
heavy-tailed `knows` graph, and messages with creator, reply and tag
edges. The same seed gives the same arrays as the program's copy.

`embeddings` gives every person and message a float32 vector, rows in
uid order (persons, posts, comments; row = uid - 1), components drawn
from N(0, 1) by one `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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



def embeddings(g: SNBGraph, dim: int, seed: int, device="cpu"):
    """(uids int64 [rows], vecs float32 [rows, dim] on `device`): one row
    per person and message, row i holding uid i + 1."""
    uids = np.concatenate([g.person_uids, g.post_uids, g.comment_uids])
    if not np.array_equal(uids, np.arange(1, len(uids) + 1)):
        raise ValueError("persons and messages must hold uids 1..rows")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    vecs = torch.randn((len(uids), dim), generator=gen, device=device,
                       dtype=torch.float32)
    return uids, vecs
