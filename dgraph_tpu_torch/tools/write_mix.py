"""An update stream for the Alpha write path over the LDBC SNB graph.

Transactions in the shapes of the LDBC SNB Interactive update
operations, each one `Alpha.mutate(..., commit_now=True)` call:

    IU1  a person with first_name, last_name, city, birthday_year and
         works_at (through set_json)
    IU2  a `likes` edge from a person to a post
    IU3  a `likes` edge from a person to a comment
    IU4  a forum with forum_title
    IU5  a `has_member` edge from a forum to a person
    IU6  a post with creation_ts, has_creator, container_of (from a
         forum) and has_tag
    IU7  a comment with creation_ts, has_creator and reply_of
    IU8  `knows` both ways between two persons who were not friends,
         with the `weight` facet
    DL   one existing `likes` edge deleted
    DK   one existing `knows` pair deleted, both ways (del_nquads)

The shapes are LDBC's. The proportions are this tool's own, not
LDBC's: the Interactive workload replays the update streams its data
generator writes, in time order, and fixes no mix of insert operations
that a tool could copy. In every 100 transactions, IU2+IU3 45, IU7 25,
IU6 10, IU8 8, IU5 6, IU1 3, IU4 1 and the deletes 2 (one of each),
shuffled within the hundred. Numbers measured over this stream (commit
latency, commits per second) describe this synthetic stream; it is no
benchmark cell. Every draw
comes from numpy's generator seeded with `seed`. A deleted edge is
never written again by the stream, and an IU8 pair is never deleted, so
reads after the stream can check each kind (`Mix.checks`).

    mix = make_mix(g, n=1000, seed=WRITE_SEED)
    for tx in mix.txns:
        alpha.mutate(**tx.kwargs())

`tag_upserts` makes the canonical Dgraph upsert over the same graph:
"tag a message with tag X, creating X if absent" — one `Alpha.upsert`
block with a query for the tag and two conditional mutations,
`@if(eq(len(t), 0))` creating the tag and `@if(gt(len(t), 0))` reusing
it. Half the blocks name an existing tag, half a new one (each new name
once), shuffled; each carries the query that reads it back
(`upsert_took`).

    for op in tag_upserts(g, n=200, seed=WRITE_SEED):
        alpha.upsert(op.src)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.models import ldbc

WRITE_SEED = 17
# transactions per hundred, by kind
PER_HUNDRED = (("IU23", 45), ("IU7", 25), ("IU6", 10), ("IU8", 8),
               ("IU5", 6), ("IU1", 3), ("IU4", 1), ("DL", 1), ("DK", 1))


@dataclass
class Txn:
    """One update transaction: its kind and the mutate() arguments."""

    kind: str
    set_nquads: str | None = None
    set_json: dict | None = None
    del_nquads: str | None = None

    def kwargs(self) -> dict:
        out = {}
        if self.set_nquads:
            out["set_nquads"] = self.set_nquads
        if self.set_json is not None:
            out["set_json"] = self.set_json
        if self.del_nquads:
            out["del_nquads"] = self.del_nquads
        return out


@dataclass
class Upsert:
    """One get-or-create tag upsert and the query that reads it back."""

    src: str
    check: str
    tag: str
    msg: int
    creates: bool


UPSERT = """upsert {{
  query {{ q(func: eq(tag_name, "{tag}")) {{ t as uid }} }}
  mutation @if(eq(len(t), 0)) {{
    set {{
      _:t <tag_name> "{tag}" .
      <{msg:#x}> <has_tag> _:t .
    }}
  }}
  mutation @if(gt(len(t), 0)) {{
    set {{ <{msg:#x}> <has_tag> uid(t) . }}
  }}
}}"""

CHECK = ('{{ q(func: eq(tag_name, "{tag}")) {{ uid '
         '~has_tag @filter(uid({msg:#x})) {{ uid }} }} }}')


def tag_upserts(g: ldbc.SNBGraph, n: int = 200, seed: int = WRITE_SEED,
                tag: str = "") -> list:
    """`n` get-or-create tag upserts over `g`, half on existing tags
    (see the module docstring); `tag` keeps new tag names apart between
    two streams over one graph."""
    rng = np.random.default_rng(seed)
    msgs = np.concatenate([g.post_uids, g.comment_uids])
    creates = rng.permutation([True] * (n // 2) + [False] * (n - n // 2))
    out = []
    for i, new in enumerate(creates):
        name = (f"new_tag{tag}_{i}" if new else
                ldbc.TAG_NAMES[int(rng.integers(g.n_tags))])
        m = int(rng.choice(msgs))
        out.append(Upsert(UPSERT.format(tag=name, msg=m),
                          CHECK.format(tag=name, msg=m), name, m,
                          bool(new)))
    return out


def upsert_took(answer: dict, op: Upsert) -> bool:
    """Whether a read-back of `op.check` shows the upsert: exactly one
    tag of that name, and the message tagged with it."""
    q = answer.get("q", [])
    return (len(q) == 1 and
            q[0].get("~has_tag", []) == [{"uid": f"{op.msg:#x}"}])


@dataclass
class Mix:
    txns: list = field(default_factory=list)
    # read-your-writes anchors: IU8 pairs, deleted likes, IU1 names
    checks: dict = field(default_factory=lambda: {
        "friends": [], "unliked": [], "unknown": [], "names": []})

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for t in self.txns:
            out[t.kind] = out.get(t.kind, 0) + 1
        return out


def make_mix(g: ldbc.SNBGraph, n: int = 1000, seed: int = WRITE_SEED,
             tag: str = "") -> Mix:
    """`n` update transactions over `g` (see the module docstring);
    `tag` keeps the names of new persons and forums apart between two
    streams over one graph."""
    rng = np.random.default_rng(seed)
    kinds = []
    for kind, k in PER_HUNDRED:
        kinds += [kind] * k
    assert len(kinds) == 100
    msgs = np.concatenate([g.post_uids, g.comment_uids])
    ts0 = int(g.creation_ts.max()) + 1
    friends = {(int(a), int(b)) for a, b in g.knows}
    taken_likes: set = set()     # deleted likes, never liked again
    unfriended: set = set()      # deleted friendships, never renewed
    renewed: set = set()         # IU8 friendships, never deleted
    mix = Mix()

    def person():
        return int(rng.choice(g.person_uids))

    for block in range(-(-n // 100)):
        order = rng.permutation(kinds)
        for kind in order[:min(100, n - 100 * block)]:
            i = len(mix.txns)
            p = person()
            if kind == "IU23":
                while True:
                    m = int(rng.choice(msgs))
                    if (p, m) not in taken_likes:
                        break
                iu = "IU2" if m < int(g.comment_uids[0]) else "IU3"
                mix.txns.append(Txn(iu, set_nquads=f"<{p:#x}> <likes> "
                                                  f"<{m:#x}> ."))
            elif kind == "IU7":
                m = int(rng.choice(msgs))
                mix.txns.append(Txn("IU7", set_nquads=(
                    f'_:c <creation_ts> "{ts0 + i}"^^<xs:int> .\n'
                    f'_:c <has_creator> <{p:#x}> .\n'
                    f'_:c <reply_of> <{m:#x}> .')))
            elif kind == "IU6":
                f = int(rng.choice(g.forum_uids))
                t = int(rng.choice(g.tag_uids))
                mix.txns.append(Txn("IU6", set_nquads=(
                    f'_:m <creation_ts> "{ts0 + i}"^^<xs:int> .\n'
                    f'_:m <has_creator> <{p:#x}> .\n'
                    f'<{f:#x}> <container_of> _:m .\n'
                    f'_:m <has_tag> <{t:#x}> .')))
            elif kind == "IU8":
                while True:
                    q = person()
                    if q != p and (p, q) not in friends \
                            and (p, q) not in unfriended:
                        break
                friends.update({(p, q), (q, p)})
                renewed.update({(p, q), (q, p)})
                w = float(np.round(rng.uniform(0.5, 10.0), 2))
                mix.txns.append(Txn("IU8", set_nquads=(
                    f"<{p:#x}> <knows> <{q:#x}> (weight={w:.2f}) .\n"
                    f"<{q:#x}> <knows> <{p:#x}> (weight={w:.2f}) .")))
                mix.checks["friends"].append((p, q))
            elif kind == "IU5":
                f = int(rng.choice(g.forum_uids))
                mix.txns.append(Txn("IU5", set_nquads=(
                    f"<{f:#x}> <has_member> <{p:#x}> .")))
            elif kind == "IU1":
                name = f"NewPerson{tag}{i}"
                o = int(rng.choice(g.org_uids))
                mix.txns.append(Txn("IU1", set_json={
                    "first_name": name,
                    "last_name": str(rng.choice(ldbc.LAST_NAMES)),
                    "city": str(rng.choice(ldbc.CITIES)),
                    "birthday_year": int(rng.integers(1950, 2005)),
                    "works_at": {"uid": f"{o:#x}"}}))
                mix.checks["names"].append(name)
            elif kind == "IU4":
                mix.txns.append(Txn("IU4", set_nquads=(
                    f'_:f <forum_title> "forum_new{tag}{i}" .')))
            elif kind == "DL":
                a, m = (int(x) for x in g.likes[rng.integers(len(g.likes))])
                if (a, m) in taken_likes:
                    a, m = (int(x) for x in g.likes[0])
                taken_likes.add((a, m))
                mix.txns.append(Txn("DL", del_nquads=(
                    f"<{a:#x}> <likes> <{m:#x}> .")))
                mix.checks["unliked"].append((a, m))
            else:   # DK: a friendship of the base graph, never an IU8 one
                while True:
                    a, b = (int(x) for x in
                            g.knows[rng.integers(len(g.knows))])
                    if (a, b) in friends and (a, b) not in renewed:
                        break
                friends.discard((a, b))
                friends.discard((b, a))
                unfriended.update({(a, b), (b, a)})
                mix.txns.append(Txn("DK", del_nquads=(
                    f"<{a:#x}> <knows> <{b:#x}> .\n"
                    f"<{b:#x}> <knows> <{a:#x}> .")))
                mix.checks["unknown"].append((a, b))
    return mix
