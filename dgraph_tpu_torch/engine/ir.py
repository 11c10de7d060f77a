"""Query IR: the SubGraph tree and filter/function nodes (port of
`dgraph_tpu/engine/ir.py`, unchanged — the parse tests compare the two
field by field).

Reference parity: `query/query.go` (SubGraph, params), `gql/parser.go`
(GraphQuery, FilterTree, Function). The DQL parser (dql/) produces this IR
directly; the executor (engine/execute.py) walks it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class FuncNode:
    """A root/filter function: eq, le, ge, lt, gt, between, uid, uid_in,
    has, type, anyofterms, allofterms, anyoftext, alloftext, regexp, match.
    Reference: gql.Function."""

    name: str
    attr: str = ""                 # predicate the func applies to
    args: list = field(default_factory=list)   # literal arguments
    uids: list = field(default_factory=list)   # uid args (uid(), uid_in())
    is_count: bool = False         # eq(count(pred), N)
    is_val_var: bool = False       # eq(val(x), N)
    lang: str = ""                 # name@en


@dataclass
class FilterNode:
    """Boolean filter tree. op ∈ {and, or, not, leaf}.
    Reference: gql.FilterTree."""

    op: str
    children: list["FilterNode"] = field(default_factory=list)
    func: Optional[FuncNode] = None


@dataclass
class Order:
    attr: str           # predicate or val-var name
    desc: bool = False
    is_val_var: bool = False
    lang: str = ""


@dataclass
class RecurseArgs:
    depth: int = 0      # 0 = unbounded (until fixpoint)
    loop: bool = False  # allow revisiting (requires depth)


@dataclass
class MsgPassArgs:
    """@msgpass(pred: emb, agg: mean) — neighbour-feature aggregation
    bound per traversal level (engine/feat.py)."""
    pred: str = ""
    agg: str = "mean"   # sum | mean | max


@dataclass
class ShortestArgs:
    from_uid: int = 0
    to_uid: int = 0
    numpaths: int = 1
    depth: int = 0
    # weight facet name (optional; uniform cost when empty)
    weight_facet: str = ""
    minweight: float = float("-inf")
    maxweight: float = float("inf")


@dataclass
class SubGraph:
    """One block level of the query tree. Reference: query.SubGraph."""

    attr: str = ""                    # predicate expanded at this level
    alias: str = ""
    is_reverse: bool = False          # ~pred
    lang: str = ""                    # pred@en for value leaves
    func: Optional[FuncNode] = None   # root function (root blocks only)
    filters: Optional[FilterNode] = None
    children: list["SubGraph"] = field(default_factory=list)

    # pagination / ordering (reference: params first/offset/after/order)
    first: int = 0
    offset: int = 0
    after: int = 0                    # uid cursor
    orders: list[Order] = field(default_factory=list)

    # node-type flags
    is_count: bool = False            # count(pred) leaf
    is_uid_leaf: bool = False         # the literal `uid` field
    checkpwd_val: Optional[str] = None  # checkpwd(pred, "pw") leaf
    is_agg: bool = False              # min/max/sum/avg(val(x)) leaf
    agg_func: str = ""
    is_val_leaf: bool = False         # val(x) leaf
    is_expand_all: bool = False       # expand(_all_) / expand(Type)
    expand_arg: str = ""

    # variable bindings (reference: var propagation between blocks)
    var_name: str = ""                # `x as friend { ... }`
    is_internal: bool = False         # var-only block: not emitted to JSON

    # directives
    recurse: Optional[RecurseArgs] = None
    msgpass: Optional[MsgPassArgs] = None
    shortest: Optional[ShortestArgs] = None
    cascade: list[str] = field(default_factory=list)  # ["__all__"] or fields
    normalize: bool = False
    groupby: list[str] = field(default_factory=list)

    # facets (reference: @facets on edges/value leaves)
    # None = not requested; [] = all keys; else [(alias, key), ...]
    facet_keys: Optional[list] = None
    facet_vars: Optional[list] = None  # [(var, key)]: @facets(v as k)
    facet_filter: Optional[FilterNode] = None  # leaf FuncNode.attr = key
    facet_orders: list[Order] = field(default_factory=list)

    # math/val computation on leaves
    math_expr: Optional[object] = None  # engine.math.MathTree

    def is_leaf(self) -> bool:
        return not self.children
