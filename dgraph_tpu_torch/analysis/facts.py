"""Facts inventory: what the port can launch, record and name.

Port of `dgraph_tpu/analysis/facts.py`. graftlint already parses every
file, so the same pass extracts one inventory of names, each pinned
both ways against its runtime registry (`tests/test_torch_lint.py`, and
`chip_smoke.py` phase 18 against what a run on the card did):

* **kernels** — the port's counterpart of the reference's jitted
  functions: each hand kernel in `utils/kbuild.SOURCES` with its
  `csrc/<name>.cu` source, the site that loads it (`kbuild.load(name)`,
  inside the wrapper's loader) and its launch sites (where the wrapper
  takes the loaded kernel to launch it), then each captured function
  (`rules.captured_functions`: what a CUDA-graph capture records).
  `kernel_launch_sites` lists every load, launch and capture site.
* **span_sites** — every `tracing.span("<name>")` and
  `tracing.trace("<name>")` site; an f-string name keeps its literal
  parts with `*` for each dynamic piece (`stage.*`).
* **metric_sites** — every literal METRICS registration.
* **lock_classes** — every `make_lock/make_rlock/make_condition` order
  class (f-string names as patterns, as above).
* **guarded_fields** / **guarded_sites** — the lock-discipline
  inventory (`guards.class_inventory`) and every `locks.guarded(self,
  ...)` arming call.
* **cost_record_fields** (`utils/costprofile.FIELDS`),
  **cost_prior_features** (`utils/costprior.FEATURES`),
  **debug_endpoints** (`server/debug_routes.DEBUG_ENDPOINTS`),
  **slo_specs** (`utils/slo.SLO_SPECS`) — re-exported verbatim from
  those torch-free modules.
* **collective_sites** — every `torch.distributed` call (through any
  import alias) with its file and line: the process group and the
  cross-process collectives, which R7 keeps in `parallel/mesh.py`; and
  every method call on a name bound to a `torch.distributed` store
  (`store.set`, `store.get`: the lead's decisions, `mesh.agree`).
* **cross_call_kinds** (`parallel/mesh.CROSS_KINDS`) — the kinds
  `mesh.CROSS_CALLS` counts, "agree" among them, read from the literal
  in their module's source.
* **fused_stage_kinds** (`engine/fused.STAGE_KINDS`) and
  **governed_caches** (`utils/memgov.GOVERNED_CACHES`) — read from the
  literal in their module's source: both modules import torch, which
  the analyzer never loads.

Emitted under `"facts"` in `--format=json` output.
"""

from __future__ import annotations

import ast
import pathlib
import re

from dgraph_tpu_torch.analysis import BENCH_SCRIPT, PACKAGE
from dgraph_tpu_torch.analysis.guards import class_inventory
from dgraph_tpu_torch.analysis.rules import (_dotted, _name_arg, _owner,
                                             _resolved, captured_functions,
                                             import_aliases)

__all__ = ["extract_facts", "literal_of", "runtime_misses"]

_LOCK_FNS = {"make_lock": "lock", "make_rlock": "rlock",
             "make_condition": "condition"}
_ROOT = pathlib.Path(__file__).resolve().parents[2]


def literal_of(contexts, rel: str, name: str):
    """The literal value a module assigns to the top-level `name`, read
    from the scanned file `rel`, or from the file on disk when the scan
    did not hold that assignment."""
    trees = [c.tree for c in contexts if c.rel == rel]
    for tree in trees + [None]:
        if tree is None:
            tree = ast.parse((_ROOT / rel).read_text(), filename=rel)
        for node in tree.body:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AnnAssign)
                       else [])
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in targets):
                return ast.literal_eval(node.value)
    raise LookupError(f"{rel} assigns no literal {name}")


def _guarded_sites(ctx) -> list[dict]:
    """Every `locks.guarded(self, "<lock>")` arming call, tagged with
    its enclosing class — the dynamic registry's static footprint."""
    out = []
    for node in ctx.nodes(ast.Call):
        if not (_dotted(node.func).rsplit(".", 1)[-1] == "guarded"
                and node.args
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id == "self"):
            continue
        cls = _owner(ctx, node)
        if cls is None:
            continue
        lock = (node.args[1].value
                if len(node.args) > 1
                and isinstance(node.args[1], ast.Constant)
                else "?")
        out.append({"class": cls.name, "file": ctx.rel,
                    "line": node.lineno, "lock": lock})
    return out


def _kernel_sites(ctx) -> list[dict]:
    """The hand-kernel sites of one file: each `kbuild.load("<name>")`
    call (a load site), and each call elsewhere in the file of the
    function that holds it (a launch site: the wrapper takes the loaded
    kernel there to launch it)."""
    aliases = import_aliases(ctx)
    loaders: dict = {}    # loader function name → kernel
    out = []
    defs = ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ctx.nodes(ast.Call):
        head, _, leaf = _dotted(node.func).rpartition(".")
        if (leaf != "load" or not head
                or aliases.get(head, head).rsplit(".", 1)[-1] != "kbuild"):
            continue
        name = _name_arg(node)
        fn = max((f for f in defs
                  if f.lineno <= node.lineno <= f.end_lineno),
                 key=lambda f: f.lineno, default=None)
        if name and fn is not None:
            loaders[fn.name] = (name, fn)
            out.append({"kernel": name, "kind": "load",
                        "file": ctx.rel, "line": node.lineno})
    for node in ctx.nodes(ast.Call):
        if (isinstance(node.func, ast.Name)
                and node.func.id in loaders):
            name, fn = loaders[node.func.id]
            if not (fn.lineno <= node.lineno <= fn.end_lineno):
                out.append({"kernel": name, "kind": "launch",
                            "file": ctx.rel, "line": node.lineno})
    return out


def _store_names(ctx, aliases) -> set:
    """The names a file binds to a `torch.distributed` store: assigned
    a call of one (`dist.PrefixStore(...)`), or another such name."""
    out: set = set()
    for node in ctx.nodes(ast.Assign):
        v = node.value
        if isinstance(v, ast.Call):
            full = _resolved(_dotted(v.func), aliases)
            if not (full.startswith("torch.distributed.")
                    and full.endswith("Store")):
                continue
        elif not (isinstance(v, ast.Name) and v.id in out):
            continue
        out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def extract_facts(contexts) -> dict:
    from dgraph_tpu_torch.utils import kbuild

    captured, sites, spans, locks = [], [], [], []
    metrics: list[dict] = []
    guarded_fields: list[dict] = []
    guarded_sites: list[dict] = []
    collectives: list[dict] = []
    for ctx in contexts:
        if not (ctx.rel.startswith(PACKAGE + "/")
                or ctx.rel == BENCH_SCRIPT):
            continue
        aliases = import_aliases(ctx)
        stores = _store_names(ctx, aliases)
        for node in ctx.nodes(ast.Call):
            full = _resolved(_dotted(node.func), aliases)
            if full.startswith("torch.distributed."):
                collectives.append({"call": full[len("torch.distributed."):],
                                    "file": ctx.rel, "line": node.lineno})
            elif (isinstance(node.func, ast.Attribute)
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id in stores):
                collectives.append({"call": f"store.{node.func.attr}",
                                    "file": ctx.rel, "line": node.lineno})
        guarded_fields.extend(class_inventory(ctx))
        guarded_sites.extend(_guarded_sites(ctx))
        sites.extend(_kernel_sites(ctx))
        cap = captured_functions(ctx)
        for fn, statics in cap.functions:
            captured.append({
                "name": fn.name, "route": "capture", "file": ctx.rel,
                "line": fn.lineno, "static_argnames": sorted(statics)})
        for line, roots in cap.sites:
            for root in roots or ["?"]:
                sites.append({"kernel": root, "kind": "capture",
                              "file": ctx.rel, "line": line})
        for node in ctx.nodes(ast.Call):
            leaf = _dotted(node.func).rsplit(".", 1)[-1]
            arg0 = _name_arg(node)
            if arg0 is None:
                continue
            if leaf in ("span", "trace"):
                spans.append({"name": arg0, "file": ctx.rel,
                              "line": node.lineno})
            elif leaf in _LOCK_FNS:
                locks.append({"name": arg0, "kind": _LOCK_FNS[leaf],
                              "file": ctx.rel, "line": node.lineno})
            elif (leaf in ("inc", "observe", "set_gauge")
                  and isinstance(node.func, ast.Attribute)
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id == "METRICS"
                  and isinstance(node.args[0], ast.Constant)):
                metrics.append({"name": arg0, "kind": leaf,
                                "file": ctx.rel, "line": node.lineno})
    kbuild_rel = f"{PACKAGE}/utils/kbuild.py"
    kbuild_line = next((node.lineno for c in contexts if c.rel == kbuild_rel
                        for node in c.tree.body
                        if isinstance(node, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == "SOURCES"
                                for t in node.targets)), None)
    hand = []
    for name in kbuild.SOURCES:
        mine = [s for s in sites if s["kernel"] == name]
        hand.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/{name}.cu",
            "file": kbuild_rel, "line": kbuild_line,
            "load_sites": [{"file": s["file"], "line": s["line"]}
                           for s in mine if s["kind"] == "load"],
            "launch_sites": [{"file": s["file"], "line": s["line"]}
                             for s in mine if s["kind"] == "launch"]})
    kernels = hand + captured
    # ONE vocabulary: the runtime schemas are imported (or read from
    # their module's literal), never re-declared
    from dgraph_tpu_torch.utils.costprofile import FIELDS as COST_FIELDS
    cost_fields = [{"name": n, "kind": d["kind"], "doc": d["doc"]}
                   for n, d in sorted(COST_FIELDS.items())]
    from dgraph_tpu_torch.utils.costprior import FEATURES as PRIOR_FEATURES
    prior_features = [{"name": n, "kind": COST_FIELDS[n]["kind"]}
                      for n in PRIOR_FEATURES]
    from dgraph_tpu_torch.server.debug_routes import DEBUG_ENDPOINTS
    debug_endpoints = [{"path": p, "doc": d}
                       for p, d in sorted(DEBUG_ENDPOINTS.items())]
    stage_kinds = literal_of(contexts, f"{PACKAGE}/engine/fused.py",
                             "STAGE_KINDS")
    fused_stages = [{"kind": k, "doc": d}
                    for k, d in sorted(stage_kinds.items())]
    caches = literal_of(contexts, f"{PACKAGE}/utils/memgov.py",
                        "GOVERNED_CACHES")
    governed_caches = [{"name": n, "doc": d}
                       for n, d in sorted(caches.items())]
    cross_kinds = [{"kind": k} for k in literal_of(
        contexts, f"{PACKAGE}/parallel/mesh.py", "CROSS_KINDS")]
    from dgraph_tpu_torch.utils.slo import SLO_SPECS
    slo_specs = [{"name": n, "doc": d}
                 for n, d in sorted(SLO_SPECS.items())]
    return {
        "kernels": kernels,
        "kernel_launch_sites": sites,
        "span_sites": spans,
        "metric_sites": metrics,
        "lock_classes": locks,
        "guarded_fields": guarded_fields,
        "guarded_sites": guarded_sites,
        "cost_record_fields": cost_fields,
        "cost_prior_features": prior_features,
        "debug_endpoints": debug_endpoints,
        "collective_sites": sorted(collectives, key=lambda c: (
            c["file"], c["line"], c["call"])),
        "cross_call_kinds": cross_kinds,
        "fused_stage_kinds": fused_stages,
        "governed_caches": governed_caches,
        "slo_specs": slo_specs,
        "totals": {
            "kernels": len(kernels),
            "hand_kernels": len(hand),
            "captured_functions": len(captured),
            "kernel_launch_sites": len(sites),
            "span_names": len({s["name"] for s in spans}),
            "metric_names": len({m["name"] for m in metrics}),
            "lock_classes": len({x["name"] for x in locks}),
            "guarded_classes": len({(g["file"], g["class"])
                                    for g in guarded_fields}),
            "guarded_fields": sum(len(g["fields"])
                                  for g in guarded_fields),
            "guarded_sites": len(guarded_sites),
            "cost_record_fields": len(cost_fields),
            "cost_prior_features": len(prior_features),
            "debug_endpoints": len(debug_endpoints),
            "collective_sites": len(collectives),
            "cross_call_kinds": len(cross_kinds),
            "fused_stage_kinds": len(fused_stages),
            "governed_caches": len(governed_caches),
            "slo_specs": len(slo_specs),
        },
    }


def _matcher(names):
    """A test of a runtime name against static names, where a `*` in a
    static name (an f-string's dynamic piece) matches any run of
    characters."""
    exact = {n for n in names if "*" not in n}
    pats = [re.compile(".*".join(map(re.escape, n.split("*"))), re.S)
            for n in names if "*" in n]
    return lambda x: x in exact or any(p.fullmatch(x) for p in pats)


def runtime_misses(facts: dict, *, locks=(), metrics=(), spans=(),
                   caches=None, launches=None, sources=None,
                   cross=()) -> list[str]:
    """What a run did that these facts do not name: lock names made,
    metric names recorded, span names recorded, cross-process call
    kinds counted (`cross`, `mesh.CROSS_CALLS`), and hand kernels that
    launched (`launches`: name → count, `sources`: name → its source
    file) without a launch site; and, both ways, the governed cache
    names it registered (`caches`, unless None) against the
    `governed_caches` inventory. An empty list means the static
    inventory covers the run."""
    from dgraph_tpu_torch.utils.metrics import DROPPED_SERIES
    out = []
    checks = (("lock", locks, [x["name"] for x in facts["lock_classes"]]),
              ("metric", metrics,
               [x["name"] for x in facts["metric_sites"]] + [DROPPED_SERIES]),
              ("span", spans, [x["name"] for x in facts["span_sites"]]))
    for what, seen, known in checks:
        match = _matcher(known)
        out += [f"{what} {n!r} has no static site"
                for n in sorted(seen) if not match(n)]
    kinds = {x["kind"] for x in facts.get("cross_call_kinds", ())}
    out += [f"cross-process call kind {k!r} not in cross_call_kinds"
            for k in sorted(cross) if k not in kinds]
    if caches is not None:
        inventory = {x["name"] for x in facts["governed_caches"]}
        out += [f"cache {n!r} registered but not in governed_caches"
                for n in sorted(set(caches) - inventory)]
        out += [f"governed cache {n!r} never registered in this run"
                for n in sorted(inventory - set(caches))]
    hand = {k["name"]: k for k in facts["kernels"] if k["route"] == "cuda"}
    for name, n in sorted((launches or {}).items()):
        k = hand.get(name)
        if not n:
            continue
        if k is None or not k["launch_sites"]:
            out.append(f"kernel {name!r} launched {n} times but has no "
                       f"static launch site")
        elif sources and sources.get(name) != k["source"]:
            out.append(f"kernel {name!r} runs {sources.get(name)!r}, the "
                       f"facts name {k['source']!r}")
    return out
