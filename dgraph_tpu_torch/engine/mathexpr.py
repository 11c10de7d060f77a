"""math() expression trees over value variables.

Port of `dgraph_tpu/engine/mathexpr.py`: the operator tables and
`MathTree` the parser builds, and `eval_math`, which evaluates a tree per
rank over the value-variable maps (a rank missing any referenced
variable is left out, as in the reference).
"""

from __future__ import annotations

import math as _m
from dataclasses import dataclass, field

BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "min": min,
    "max": max,
    "logbase": lambda a, b: _m.log(a, b),
    "pow": lambda a, b: a ** b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "&&": lambda a, b: bool(a) and bool(b),
    "||": lambda a, b: bool(a) or bool(b),
}

UNOPS = {
    "u-": lambda a: -a,
    "ln": _m.log,
    "exp": _m.exp,
    "sqrt": _m.sqrt,
    "floor": _m.floor,
    "ceil": lambda a: _m.ceil(a),
    "abs": abs,
    "not": lambda a: not a,
}


@dataclass
class MathTree:
    """op ∈ BINOPS|UNOPS|{'const','var','cond'}."""

    op: str
    const: object = None
    var: str = ""
    children: list["MathTree"] = field(default_factory=list)


def eval_math(tree: MathTree, ranks, val_vars: dict) -> dict[int, object]:
    """Evaluate per rank; ranks missing any referenced var are skipped
    (reference behavior: missing values drop the uid from the result)."""
    out: dict[int, object] = {}
    for r in ranks:
        r = int(r)
        try:
            v = _eval_one(tree, r, val_vars)
        except _Missing:
            continue
        out[r] = v
    return out


class _Missing(Exception):
    pass


def _eval_one(t: MathTree, rank: int, env: dict):
    if t.op == "const":
        return t.const
    if t.op == "var":
        var = env.get(t.var)
        if var is None or rank not in var:
            raise _Missing()
        return var[rank]
    if t.op == "cond":
        c, a, b = t.children
        return _eval_one(a if _eval_one(c, rank, env) else b, rank, env)
    if t.op in UNOPS:
        return UNOPS[t.op](_eval_one(t.children[0], rank, env))
    if t.op in BINOPS:
        return BINOPS[t.op](_eval_one(t.children[0], rank, env),
                            _eval_one(t.children[1], rank, env))
    raise ValueError(f"unknown math op {t.op!r}")
