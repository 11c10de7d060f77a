"""@groupby: group a level's nodes by predicate values and aggregate.

Port of `dgraph_tpu/engine/groupby.py`, whole: groups the uids of a block
(or of each parent's row, for a nested @groupby) by the values of the
groupby predicates — a uid predicate contributes every edge target — and
evaluates the block's aggregate children (count(uid), min/max/sum/avg of
value variables) per group.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.store.types import Kind


@dataclass
class GroupResult:
    # group key attrs in declaration order
    attrs: list[str] = field(default_factory=list)
    # each group: ({attr: value}, {agg_label: value}, member_ranks)
    groups: list[tuple[dict, dict, np.ndarray]] = field(default_factory=list)


def process_groupby(ex, node) -> GroupResult:
    """Root-level @groupby: one group table over the block's nodes."""
    return _group_population(ex, node.sg, node.nodes)


def process_groupby_rows(ex, node) -> dict[int, GroupResult]:
    """Child-level @groupby: one group table PER PARENT over that parent's
    matrix row (reference: groupby applies within each parent's edge list)."""
    out: dict[int, GroupResult] = {}
    for pos in np.unique(node.matrix_seg).tolist():
        members = np.unique(
            node.matrix_child[node.matrix_seg == pos]).astype(np.int32)
        out[int(pos)] = _group_population(ex, node.sg, members)
    return out


def _group_population(ex, sg, pop: np.ndarray) -> GroupResult:
    res = GroupResult(attrs=list(sg.groupby))
    if not len(pop):
        return res

    # group key(s) per rank: scalar attrs contribute their first value, uid
    # attrs contribute EVERY edge target (a node with two genres joins two
    # groups — the reference's canonical groupby-on-uid-predicate case)
    keys: dict[tuple, list[int]] = {}
    for r in pop:
        per_attr = [_key_values(ex.store, a, int(r)) for a in sg.groupby]
        if any(not vs for vs in per_attr):
            continue  # nodes missing a group key are dropped (ref behavior)
        combos = [()]
        for vs in per_attr:
            combos = [c + (v,) for c in combos for v in vs]
        for key in combos:
            keys.setdefault(key, []).append(int(r))

    for key in sorted(keys, key=lambda k: tuple(str(x) for x in k)):
        members = np.array(sorted(keys[key]), np.int32)
        aggs: dict[str, object] = {}
        for c in sg.children:
            label = c.alias or (f"{c.agg_func}(val({c.attr}))" if c.is_agg
                                else "count")
            if c.is_count and (c.attr == "uid" or c.is_uid_leaf):
                aggs[label if c.alias else "count"] = len(members)
            elif c.is_agg:
                var = ex.val_vars.get(c.attr, {})
                vals = [var[m] for m in members.tolist() if m in var]
                v = _aggregate(c.agg_func, vals)
                if v is not None:  # min/max over no values: omit
                    aggs[label] = v
        res.groups.append(({a: k for a, k in zip(sg.groupby, key)}, aggs,
                           members))
    return res


def _key_values(store, attr: str, rank: int) -> list:
    """Group-key values of `attr` on `rank`: first scalar value, or all uid
    edge targets rendered as hex-uid strings."""
    ps = store.schema.peek(attr.lstrip("~"))
    if ps is not None and ps.kind == Kind.UID:
        rel = store.rel(attr.lstrip("~"), reverse=attr.startswith("~"))
        return [f"0x{int(store.uid_of(t)):x}" for t in rel.row(rank)]
    vs = store.values_for(attr, rank)
    return vs[:1]


def _aggregate(fn: str, vals: list):
    if not vals:
        # reference: sum/avg over an empty set render 0; min/max omit
        return 0 if fn in ("sum", "avg") else None
    if fn == "min":
        return min(vals)
    if fn == "max":
        return max(vals)
    if fn == "sum":
        return sum(vals)
    if fn == "avg":
        return sum(vals) / len(vals)
    raise ValueError(f"unknown aggregate {fn!r}")
