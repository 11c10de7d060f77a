"""math() expression trees: the part the parser builds.

Port of `dgraph_tpu/engine/mathexpr.py` as far as `dql/parser.py` needs
it (the operator tables and `MathTree`). Evaluating a tree over value
variables (`eval_math`) belongs to the per-query engine, ROADMAP Queue 1
item 4.
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
