"""Block execution ordering by variable dependency.

Port of `dgraph_tpu/engine/varorder.py`: a block consuming `uid(x)` /
`val(x)` runs after the block defining `x`, whatever the textual order.
"""

from __future__ import annotations

from dgraph_tpu_torch.engine.ir import FilterNode, FuncNode, SubGraph
from dgraph_tpu_torch.engine.mathexpr import MathTree


def collect_defs(sg: SubGraph) -> set[str]:
    out = set()
    if sg.var_name:
        out.add(sg.var_name)
    for c in sg.children:
        out |= collect_defs(c)
    return out


def collect_uses(sg: SubGraph) -> set[str]:
    out: set[str] = set()
    if sg.func is not None:
        out |= _func_uses(sg.func)
    if sg.filters is not None:
        out |= _filter_uses(sg.filters)
    for o in sg.orders:
        if o.is_val_var:
            out.add(o.attr)
    if sg.is_val_leaf or sg.is_agg:
        out.add(sg.attr)
    if sg.math_expr is not None:
        out |= _math_uses(sg.math_expr)
    for c in sg.children:
        out |= collect_uses(c)
    return out


def _func_uses(f: FuncNode) -> set[str]:
    if f.name == "uid":
        return {a for a in f.args if isinstance(a, str)}
    if f.is_val_var:
        return {f.attr}
    return set()


def _filter_uses(t: FilterNode) -> set[str]:
    out = set()
    if t.func is not None:
        out |= _func_uses(t.func)
    for c in t.children:
        out |= _filter_uses(c)
    return out


def _math_uses(t: MathTree) -> set[str]:
    out = set()
    if t.op == "var":
        out.add(t.var)
    for c in t.children:
        out |= _math_uses(c)
    return out


def execution_order(blocks: list[SubGraph]) -> list[int]:
    """Indices of `blocks` in dependency-satisfying execution order.

    Unresolvable references (a var no block defines) are tolerated;
    circular dependencies between blocks raise."""
    defs = [collect_defs(b) for b in blocks]
    all_defined: set[str] = set().union(*defs) if defs else set()
    # only vars some block defines create ordering constraints
    uses = [collect_uses(b) & all_defined for b in blocks]
    done: set[str] = set()
    remaining = list(range(len(blocks)))
    order: list[int] = []
    # graftlint: allow(hot-loop-checkpoint): parse-time planning,
    # bounded by the query's block count
    while remaining:
        progressed = False
        for i in list(remaining):
            if (uses[i] - defs[i]) <= done:
                order.append(i)
                remaining.remove(i)
                done |= defs[i]
                progressed = True
        if not progressed:
            names = [blocks[i].alias for i in remaining]
            raise ValueError(
                f"circular variable dependency between blocks {names}")
    return order
