"""SubGraph execution pieces the batched `@recurse` slice uses.

Port of part of `dgraph_tpu/engine/execute.py`: `LevelNode`, the host
CSR row gather `csr_rows`, the expansion rule `expands`, and the
`Executor` members that root evaluation, var binding and the JSON
renderer call (`root_ranks`, `_leaf_set`, `_record_leaf_vars`,
`_expands`). Per-query block execution — the device hop, filters,
ordering, pagination, facets — is ROADMAP Queue 1 items 3-4.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.engine.funcs import EMPTY, eval_func
from dgraph_tpu_torch.engine.ir import FuncNode, SubGraph
from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.store.types import Kind

EMPTY64 = np.zeros(0, np.int64)


@dataclass
class LevelNode:
    sg: SubGraph
    nodes: np.ndarray                      # sorted unique int32 ranks
    display: np.ndarray | None = None      # root blocks: ordered rank list
    children: list["LevelNode"] = field(default_factory=list)
    leaf_sgs: list[SubGraph] = field(default_factory=list)
    recurse_data: object | None = None     # engine.recurse.RecurseData


def csr_rows(rel, frontier: np.ndarray):
    """Host CSR row gather for a frontier → (neighbors, seg, edge_pos)."""
    starts = rel.indptr[frontier]
    deg = rel.indptr[frontier + 1] - starts
    total = int(deg.sum())
    if total == 0:
        return EMPTY, EMPTY, EMPTY64
    seg = np.repeat(np.arange(len(frontier), dtype=np.int32), deg)
    base = np.repeat(np.cumsum(deg) - deg, deg)
    pos = np.repeat(starts.astype(np.int64), deg) + \
        (np.arange(total, dtype=np.int64) - base)
    return rel.indices[pos], seg, pos


class Executor:
    """Root evaluation and variable environments over a Store snapshot."""

    def __init__(self, store: Store):
        self.store = store
        # variable environments (reference: query var propagation)
        self.uid_vars: dict[str, np.ndarray] = {}
        self.val_vars: dict[str, dict[int, object]] = {}

    def _var_ranks(self, name: str) -> np.ndarray:
        """uid(x): a uid var's ranks, or a val var's uid domain."""
        if name in self.uid_vars:
            return self.uid_vars[name]
        if name in self.val_vars:
            return np.array(sorted(self.val_vars[name]), np.int32)
        raise ValueError(f"variable {name!r} is used but not defined")

    def _leaf_set(self, f: FuncNode, universe: np.ndarray) -> np.ndarray:
        if f.name == "uid" and (f.args or not f.uids):
            # mixed literals and variables: union both
            parts = [self._var_ranks(a) for a in f.args]
            if f.uids:
                r = self.store.rank_of(np.array(f.uids, np.int64))
                parts.append(r[r >= 0].astype(np.int32))
            return (np.unique(np.concatenate(parts)).astype(np.int32)
                    if parts else EMPTY)
        return eval_func(self.store, f, self.val_vars)

    def root_ranks(self, sg: SubGraph) -> np.ndarray:
        f = sg.func
        if f is None:
            return EMPTY
        return self._leaf_set(f, EMPTY)

    def _expands(self, sg: SubGraph) -> bool:
        return expands(self.store.schema, sg)

    def _record_leaf_vars(self, sg: SubGraph, parent: LevelNode) -> None:
        """Bind value/count vars declared on leaves (a as age, c as count(p))."""
        if not sg.var_name:
            return
        if sg.is_uid_leaf and not sg.is_count:
            self.uid_vars[sg.var_name] = parent.nodes
            return
        if sg.is_count:
            rel = self.store.rel(sg.attr, sg.is_reverse)
            deg = rel.degree(parent.nodes)
            self.val_vars[sg.var_name] = {
                int(r): int(d) for r, d in zip(parent.nodes, deg)}
        elif sg.math_expr is not None or sg.is_val_leaf:
            raise NotImplementedError(
                "math()/val() variables are not ported yet (ROADMAP "
                "Queue 1 item 4: engine/mathexpr.py, engine/execute.py)")
        else:
            env: dict[int, object] = {}
            for r in parent.nodes:
                vs = self.store.values_for(sg.attr, int(r), sg.lang)
                if vs:
                    env[int(r)] = vs[0]
            self.val_vars[sg.var_name] = env


def expands(schema, sg: SubGraph) -> bool:
    """Whether a child block triggers uid expansion (vs a value leaf).
    Shared by the executor and the batch planner."""
    if (sg.is_count or sg.is_uid_leaf or sg.is_agg or sg.is_val_leaf
            or sg.math_expr is not None):
        return False
    if sg.is_reverse or sg.children or sg.recurse or sg.shortest:
        return True
    ps = schema.peek(sg.attr)
    return bool(ps and ps.kind == Kind.UID)
