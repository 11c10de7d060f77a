"""Query engine: IR, executor, recurse/shortest, JSON output.

Port of `dgraph_tpu/engine`. `Engine` is the per-query entry point:

    Engine(store).query_bytes('{ q(func: uid(0x1)) { friend { name } } }')

parses DQL, executes each block level by level (frontiers of at least
`device_threshold` rows expand on `device`, or on every shard of `mesh`
when one is given, smaller ones on the host) and renders the reference's
JSON. Parsing, execution and rendering run in
spans and `torch.profiler` ranges (`engine.parse`, `engine.query`,
`engine.render`) so a profile splits a query's host time by layer.
"""

from __future__ import annotations

import json


from dgraph_tpu_torch.engine.execute import (Executor, LevelNode, RouteCounts,
                                             check_mesh)
from dgraph_tpu_torch.engine.ir import (
    FilterNode, FuncNode, Order, RecurseArgs, ShortestArgs, SubGraph,
)
from dgraph_tpu_torch.engine.emit import to_json_bytes
from dgraph_tpu_torch.engine.outputnode import to_json
from dgraph_tpu_torch.utils import costprofile, tracing
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def shape_of(blocks) -> str:
    """Compact structural fingerprint of a parsed query (root func name,
    modifiers, tree depth, recurse depth — never argument values)."""
    parts = []
    for sg in blocks[:4]:
        p = sg.func.name if sg.func is not None else "uid"
        mods = ""
        if sg.recurse is not None:
            mods += f"~r{sg.recurse.depth or 0}"
        if sg.msgpass is not None:
            mods += "~m"
        if sg.shortest is not None:
            mods += "~sp"
        if sg.filters is not None:
            mods += "~f"
        if sg.var_name:
            mods += "~v"
        d, node = 0, sg
        # graftlint: allow(hot-loop-checkpoint): bounded by the parsed
        # tree's depth (parser-limited), no data-dependent iteration
        while node.children:
            d += 1
            node = node.children[0]
        parts.append(f"{p}{mods}~d{d}")
    if len(blocks) > 4:
        parts.append(f"+{len(blocks) - 4}")
    return "q:" + ",".join(parts)


class Engine:
    """Parse + execute + render DQL queries over a Store snapshot.

    `device` defaults to the card and raises without one unless the
    caller names "cpu". `mesh` (`parallel/mesh.make_mesh`, devices of
    `device`'s type) serves the expansions sharded. `routes` accumulates,
    over every query this engine serves, the expansions and edges each
    execution route took."""

    def __init__(self, store, device=DEFAULT_DEVICE,
                 device_threshold: int = 512, mesh=None):
        self.store = store
        self.device = resolve_device(device)
        self.device_threshold = device_threshold
        self.mesh = check_mesh(mesh, self.device)
        self.routes = RouteCounts()

    def query(self, q: str, variables: dict | None = None) -> dict:
        out, _ex = self.query_with_vars(q, variables)
        return out

    def query_with_vars(self, q: str, variables: dict | None = None):
        """(json, executor): the executor carries the bound uid/val vars."""
        res, ex = self._run(q, variables)
        if ex is None:
            return res, None
        with tracing.span("engine.render"):
            return to_json(ex, res), ex

    def query_bytes(self, q: str, variables: dict | None = None) -> bytes:
        """Serialized response bytes: the native emitter
        (`engine/emit.py`) where the block shape allows, the dict
        renderer's compact JSON elsewhere."""
        res, ex = self._run(q, variables)
        with tracing.span("engine.render"):
            if ex is None:
                return json.dumps(res, separators=(",", ":")).encode()
            return to_json_bytes(ex, res)

    def _run(self, q: str, variables: dict | None = None):
        """Parse + execute: (LevelNode roots, executor), or for schema{}
        introspection (dict, None)."""
        from dgraph_tpu_torch.dql.parser import parse, parse_schema_query
        from dgraph_tpu_torch.engine.varorder import execution_order

        with tracing.span("engine.parse"):
            sq = parse_schema_query(q)
            if sq is not None:
                return self._schema_query(*sq), None
            blocks = parse(q, variables)
            order = execution_order(blocks)
        # the request's cost-profile shape key (utils/costprofile.py)
        costprofile.add_shape(shape_of(blocks))
        costprofile.add("queries", 1)
        ex = Executor(self.store, device=self.device,
                      device_threshold=self.device_threshold,
                      routes=self.routes, mesh=self.mesh)
        results: dict[int, LevelNode] = {}
        with tracing.span("engine.query", blocks=len(blocks)):
            for i in order:
                results[i] = ex.run_block(blocks[i])
        roots = [results[i] for i in range(len(blocks))]  # textual order out
        return roots, ex

    def _schema_query(self, preds, fields) -> dict:
        """schema{} introspection: the predicate list plus type
        definitions."""
        out = []
        schema = self.store.schema
        for name in sorted(schema.predicates):
            if preds is not None and name not in preds:
                continue
            ps = schema.predicates[name]
            d = {"predicate": name, "type": ps.kind.value}
            if ps.is_list:
                d["list"] = True
            if ps.index_tokenizers:
                d["index"] = True
                d["tokenizer"] = list(ps.index_tokenizers)
            for flag in ("reverse", "count", "lang", "upsert", "unique"):
                if getattr(ps, flag):
                    d[flag] = True
            if fields is not None:
                d = {k: v for k, v in d.items()
                     if k in fields or k == "predicate"}
            out.append(d)
        resp = {"schema": out}
        if preds is None:
            types = [{"name": t,
                      "fields": [{"name": f} for f in td.fields]}
                     for t, td in sorted(schema.types.items())]
            if types:
                resp["types"] = types
        return resp


__all__ = [
    "Engine", "Executor", "LevelNode", "RouteCounts", "SubGraph",
    "FuncNode", "FilterNode", "Order", "RecurseArgs", "ShortestArgs",
    "to_json", "to_json_bytes", "shape_of",
]
