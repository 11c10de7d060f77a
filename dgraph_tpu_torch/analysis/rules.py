"""graftlint rules R1-R8 and R13-R15, aimed at the port's files and idiom.

Port of `dgraph_tpu/analysis/rules.py`. Each rule is deliberately a
HEURISTIC with a waiver escape hatch, not a proof system: breaking an
invariant in a refactor must mean writing a visible, reasoned waiver
instead of passing silently. Rule names are the reference's, so a
finding means the same on both packages.

R1 hot-loop-checkpoint   while-loops in engine/, ops/, cluster/ call
                         `checkpoint()` once per iteration.
R2 direct-io             no outbound socket/gRPC/HTTP constructors
                         outside server/task.py's Client.
R3 wall-clock            no `time.time()`: deadline/backoff arithmetic
                         is monotonic-only; wall clock needs a reasoned
                         waiver (timestamps that leave the process).
R4 retry-deadline        a retry loop (sleep + broad except) must
                         exclude DEADLINE_EXCEEDED / DeadlineExceeded /
                         Cancelled from re-attempts.
R5 metric-docs           metric names are string literals, label sets
                         are explicit kwargs (no **splat), and every
                         name has a README observability-table row.
R6 jit-purity            capture purity: no host sync (`.item()`,
                         `.tolist()`, `.cpu()`, `.numpy()`,
                         `torch.cuda.synchronize`), no numpy host op and
                         no Python branch on a tensor parameter inside a
                         function recorded into a CUDA graph. The
                         port's counterpart of `jax.jit` is the capture
                         at engine/fused.py (`_Program._capture` over
                         `_build_program` and `_STAGE_EMITTERS`): a
                         capture runs the function's host side once and
                         each replay runs its device work alone, the
                         hazard of code that runs at trace time only.
R7 shard-map-compat      the mesh layer's collectives resolve only
                         through parallel/mesh.py: a direct
                         `torch.distributed` reference (or a
                         `shard_map` spelling of the reference's)
                         anywhere else pins the layer to one backend;
                         so does a reach for the store of the lead's
                         decisions (`mesh._DECISIONS`) past
                         `mesh.agree`.
R8 atomic-write          durable files under store/ (and
                         server/backup.py) land via tmp + fsync +
                         os.replace.

R9-R12 (lock discipline and data races) live in `guards.py`.

R13 fused-host-callback  a captured function in the fused-program layer
                         (engine/fused.py, ops/) may not call costprofile,
                         tracing, METRICS, deadline, flightrec or kbuild
                         accounting: it would run once, at capture, and
                         never on a replay. Count around the replay
                         (`feat_ops.count_replay` in `_Program.run`).
R14 cache-registration   byte-holding caches join the memory governor:
                         every `Memo(...)` states its `governed=`, and a
                         file that grows a dict-typed `*_cache`
                         attribute registers with memgov.GOVERNOR.
R15 slo-spec             SLO names stay inside utils/slo.SLO_SPECS.

A function is captured (R6, R13, and the facts' `kernels`) when a
`with torch.cuda.graph(...)` body calls it, or when a captured function
of the same module calls it, by name or through a module-level dict of
functions. The reference's `jax.jit` / `shard_map` spellings (decorated,
or handed by name) count too, so both analyzers read the reference's
fixtures alike; the port has none. A capture body that calls `self.<attr>(...)` is
followed to the function its class was built with (`_Program(
_build_program(...), ...)` captures what `_build_program` returns); a
call the rule cannot follow there is itself a finding.
"""

from __future__ import annotations

import ast

from dgraph_tpu_torch.analysis import (BENCH_SCRIPT, PACKAGE, FileContext,
                                       Finding, Rule)

__all__ = ["default_rules", "HotLoopCheckpoint", "DirectIO", "WallClock",
           "RetryDeadline", "MetricDocs", "CapturePurity", "ShardMapCompat",
           "FusedHostCallback", "AtomicWrite", "CacheRegistration",
           "SloSpec", "captured_functions", "import_aliases"]

P = PACKAGE + "/"


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name for a call target: `a.b.c` or `name`;
    "" when the target is dynamic (subscript, call result, ...)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _name_arg(call: ast.Call) -> str | None:
    """A call's first argument as a name (a lock's order class, a span's
    or a kernel's name): the literal, or an f-string's literal parts
    with `*` for each dynamic piece (`f"admission.{lane}"` →
    "admission.*"); None for anything else."""
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value
    if isinstance(a, ast.JoinedStr):
        return "".join(v.value if (isinstance(v, ast.Constant)
                                   and isinstance(v.value, str)) else "*"
                       for v in a.values)
    return None


def _walk_no_defs(node: ast.AST):
    """Walk a subtree without descending into nested function/class
    definitions (their bodies run in another context)."""
    todo = list(ast.iter_child_nodes(node))
    while todo:
        n = todo.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(n))


def import_aliases(ctx: FileContext) -> dict[str, str]:
    """Local name → the dotted module or object it was imported as
    (`from x.utils import deadline as dl` gives dl → x.utils.deadline);
    computed once per file."""
    out = ctx.memo.get("aliases")
    if out is not None:
        return out
    out = ctx.memo["aliases"] = {}
    for node in ctx.nodes(ast.Import, ast.ImportFrom):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    head = a.name.split(".", 1)[0]
                    out.setdefault(head, head)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _resolved(dotted: str, aliases: dict[str, str]) -> str:
    """`dotted` with its first segment replaced by what it was imported
    as (unchanged when it was not imported)."""
    head, _, rest = dotted.partition(".")
    full = aliases.get(head)
    if not full:
        return dotted
    return f"{full}.{rest}" if rest else full


# ---------------------------------------------------------------------------
class HotLoopCheckpoint(Rule):
    name = "hot-loop-checkpoint"
    doc = ("unbounded-iteration (`while`) loops on the serving path "
           "must call `deadline.checkpoint()` once per iteration so a "
           "pathological query cancels within one loop body of its "
           "budget")

    SCOPES = (P + "engine/", P + "ops/", P + "cluster/")

    def applies(self, rel: str) -> bool:
        return rel.startswith(self.SCOPES)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ctx.nodes():
            if not isinstance(node, ast.While):
                continue
            has_cp = any(
                isinstance(n, ast.Call)
                and _dotted(n.func).rsplit(".", 1)[-1]
                in ("checkpoint", "check")
                for n in ast.walk(node))
            if not has_cp:
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    "while-loop without a deadline checkpoint — call "
                    "deadline.checkpoint(stage) once per iteration, or "
                    "waive with the bound that makes it safe"))
        return out


# ---------------------------------------------------------------------------
class DirectIO(Rule):
    name = "direct-io"
    doc = ("outbound network constructors are allowed only inside "
           "server/task.py's Client — everything else must ride "
           "`Client._call` so breakers/retries/budget forwarding "
           "apply")

    BANNED = frozenset({
        "grpc.insecure_channel", "grpc.secure_channel",
        "socket.socket", "socket.create_connection",
        "urllib.request.urlopen", "http.client.HTTPConnection",
        "http.client.HTTPSConnection", "requests.get", "requests.post",
        "requests.put", "requests.delete", "requests.request",
        "requests.Session",
    })
    WRAPPER = P + "server/task.py"

    def applies(self, rel: str) -> bool:
        return rel.startswith(P) and rel != self.WRAPPER

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ctx.nodes():
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in self.BANNED:
                    out.append(Finding(
                        self.name, ctx.rel, node.lineno,
                        f"direct network call {d}() outside "
                        f"server/task.py Client._call — outbound RPCs "
                        f"must ride the resilience wrapper"))
        return out


# ---------------------------------------------------------------------------
class WallClock(Rule):
    name = "wall-clock"
    doc = ("no `time.time()` in the package — deadline/backoff "
           "arithmetic uses monotonic clocks (utils/deadline.py "
           "helpers); wall clock is only for timestamps that leave "
           "the process, and says so in a waiver")

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ctx.nodes():
            if (isinstance(node, ast.Call)
                    and _dotted(node.func) in ("time.time",
                                               "_time.time")):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    "wall-clock time.time() — deadline/backoff "
                    "arithmetic must use monotonic clocks "
                    "(utils/deadline.monotonic_s); waive only for "
                    "timestamps that cross process boundaries"))
        return out


# ---------------------------------------------------------------------------
class RetryDeadline(Rule):
    name = "retry-deadline"
    doc = ("a retry loop (sleep + broad exception handler) must "
           "exclude DEADLINE_EXCEEDED and application errors from "
           "re-attempts — the budget died, not the peer")

    BROAD = frozenset({"Exception", "BaseException", "OSError",
                       "ConnectionError", "RpcError", "grpc.RpcError"})
    EXCLUDERS = frozenset({"DeadlineExceeded", "Cancelled",
                           "DEADLINE_EXCEEDED"})

    def _broad_handler(self, h: ast.ExceptHandler) -> bool:
        if h.type is None:
            return True
        types = (h.type.elts if isinstance(h.type, ast.Tuple)
                 else [h.type])
        return any(_dotted(t) in self.BROAD
                   or _dotted(t).rsplit(".", 1)[-1] in self.BROAD
                   for t in types)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ctx.nodes():
            if not isinstance(node, (ast.For, ast.While)):
                continue
            body = list(_walk_no_defs(node))
            has_sleep = any(
                isinstance(n, ast.Call)
                and _dotted(n.func).endswith("sleep")
                for n in body)
            broad = [n for n in body
                     if isinstance(n, ast.ExceptHandler)
                     and self._broad_handler(n)]
            if not (has_sleep and broad):
                continue
            names = {n.id for n in body if isinstance(n, ast.Name)}
            names |= {n.attr for n in body
                      if isinstance(n, ast.Attribute)}
            if not (names & self.EXCLUDERS):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    "retry loop with a broad exception handler does "
                    "not exclude DEADLINE_EXCEEDED/DeadlineExceeded/"
                    "Cancelled — retries must never re-spend an "
                    "expired budget or re-apply an answered request"))
        return out


# ---------------------------------------------------------------------------
class MetricDocs(Rule):
    name = "metric-docs"
    doc = ("METRICS registrations use literal names and explicit "
           "label kwargs (the runtime cardinality guard bounds "
           "values; literals bound the NAME space), and every name "
           "has a backticked row in README's observability table")

    METHODS = frozenset({"inc", "observe", "set_gauge"})

    def __init__(self):
        self.names: set[str] = set()

    def applies(self, rel: str) -> bool:
        return rel.startswith(P) or rel == BENCH_SCRIPT

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ctx.nodes():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.METHODS
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "METRICS"):
                continue
            if not node.args or not (
                    isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    "metric name must be a string literal — a dynamic "
                    "name defeats both the README doc table and the "
                    "per-name cardinality guard"))
                continue
            name = node.args[0].value
            self.names.add(name)
            if any(kw.arg is None for kw in node.keywords):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    f"metric {name!r} expands a dynamic **label dict — "
                    f"label KEYS must be explicit kwargs so the label "
                    f"schema stays reviewable and bounded"))
        return out

    def finalize(self, analyzer) -> list[Finding]:
        from dgraph_tpu_torch.utils.metrics import DROPPED_SERIES
        names = self.names | {DROPPED_SERIES}
        readme = analyzer.readme_text
        missing = sorted(n for n in names if f"`{n}" not in readme)
        if not missing:
            return []
        return [Finding(
            self.name, "README.md", 1,
            f"metric name(s) emitted but undocumented in README's "
            f"observability table: {missing}")]


# ---------------------------------------------------------------------------
# what a module captures (R6, R13 and facts.py read this)

# the reference's wrappers whose function argument runs at trace time
WRAPPERS = frozenset({
    "jax.jit", "jit", "jax.shard_map", "shard_map", "jax.pmap", "pmap",
    "pjit", "jax.experimental.shard_map.shard_map"})
DECORATORS = frozenset({"jax.jit", "jit"})
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph"})


def _statics(call: ast.Call) -> set[str]:
    for kw in call.keywords:
        if kw.arg in ("static_argnames", "static_argnums"):
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                return {v.value}
            if isinstance(v, (ast.Tuple, ast.List)):
                return {e.value for e in v.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)}
    return set()


class Captured:
    """One module's captured code: `functions` is [(FunctionDef,
    static_argnames)] in source order, `bodies` the `with
    torch.cuda.graph(...)` statements, `sites` [(line, [root function
    names])] per capture body, and `unresolved` [(line, call)] for the
    calls in a capture body the rule could not follow."""

    def __init__(self):
        self.functions: list = []
        self.bodies: list = []
        self.sites: list = []
        self.unresolved: list = []


def _is_capture(w: ast.With, aliases: dict) -> bool:
    return any(isinstance(it.context_expr, ast.Call)
               and _resolved(_dotted(it.context_expr.func), aliases)
               in CAPTURE_CONTEXTS for it in w.items)


def _returned_defs(fn: ast.FunctionDef) -> list:
    """The nested functions `fn` returns by name."""
    nested = {n.name: n for n in fn.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return [nested[n.value.id] for n in _walk_no_defs(fn)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Name)
            and n.value.id in nested]


def _built_with(ctx: FileContext, cls: ast.ClassDef, attr: str,
                funcs: dict) -> list | None:
    """What `self.<attr>` holds in instances of `cls`, when the class
    stores a constructor parameter there and the module builds it from
    a call of one of its own functions: the nested functions that
    function returns. None when that cannot be followed."""
    init = next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                 and n.name == "__init__"), None)
    if init is None:
        return None
    params = [a.arg for a in init.args.args[1:]]
    param = next((n.value.id for n in _walk_no_defs(init)
                  if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Name)
                  and n.value.id in params
                  and any(isinstance(t, ast.Attribute) and t.attr == attr
                          and _dotted(t.value) == "self"
                          for t in n.targets)), None)
    if param is None:
        return None
    pos = params.index(param)
    out = []
    for call in ctx.nodes(ast.Call):
        if _dotted(call.func) != cls.name:
            continue
        arg = (call.args[pos] if pos < len(call.args) else
               next((k.value for k in call.keywords if k.arg == param),
                    None))
        if not (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name)
                and arg.func.id in funcs):
            return None
        built = _returned_defs(funcs[arg.func.id])
        if not built:
            return None
        out.extend(built)
    return out or None


def _owner(ctx: FileContext, node: ast.AST):
    """The innermost class whose body holds `node`, by line span."""
    best = None
    for c in ctx.nodes(ast.ClassDef):
        if (c.lineno <= node.lineno <= c.end_lineno
                and (best is None or c.lineno > best.lineno)):
            best = c
    return best


def captured_functions(ctx: FileContext) -> Captured:
    """The module's captured code (see the module docstring); computed
    once per file."""
    got = ctx.memo.get("captured")
    if got is not None:
        return got
    cap = ctx.memo["captured"] = Captured()
    tree = ctx.tree
    aliases = import_aliases(ctx)
    funcs = {n.name: n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    tables = {}      # module-level dicts of module functions
    for n in tree.body:
        if (isinstance(n, (ast.Assign, ast.AnnAssign))
                and isinstance(n.value, ast.Dict)):
            vals = [v.id for v in n.value.values
                    if isinstance(v, ast.Name) and v.id in funcs]
            if vals:
                for t in (n.targets if isinstance(n, ast.Assign)
                          else [n.target]):
                    if isinstance(t, ast.Name):
                        tables[t.id] = vals
    found: dict = {}     # id(def) → (def, statics)

    def add(fn, statics=frozenset()):
        if id(fn) not in found:
            found[id(fn)] = (fn, set(statics))

    by_name: dict = {}
    for node in ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
        by_name.setdefault(node.name, node)
    # wrappers: decorated, or handed by name to a wrapper call
    handed: dict = {}
    for node in ctx.nodes(ast.Call):
        if ((_dotted(node.func) in WRAPPERS
             or _resolved(_dotted(node.func), aliases) in WRAPPERS)
                and node.args and isinstance(node.args[0], ast.Name)):
            handed[node.args[0].id] = _statics(node)
    for node in ctx.nodes(ast.FunctionDef):
        for dec in node.decorator_list:
            d = _dotted(dec)
            if d in DECORATORS or _resolved(d, aliases) in DECORATORS:
                add(node)
                break
            if (isinstance(dec, ast.Call)
                    and _dotted(dec.func) == "functools.partial"
                    and dec.args
                    and (_dotted(dec.args[0]) in DECORATORS
                         or _resolved(_dotted(dec.args[0]), aliases)
                         in DECORATORS)):
                add(node, _statics(dec))
                break
        else:
            if node.name in handed:
                add(node, handed[node.name])
    # capture bodies: what a `with torch.cuda.graph(...)` records
    for w in ctx.nodes(ast.With):
        if not _is_capture(w, aliases):
            continue
        cap.bodies.append(w)
        roots = []
        for stmt in w.body:
            for n in [stmt, *_walk_no_defs(stmt)]:
                if not isinstance(n, ast.Call):
                    continue
                d = _dotted(n.func)
                if isinstance(n.func, ast.Name) and d in by_name:
                    add(by_name[d])
                    roots.append(d)
                elif d.startswith("self.") and d.count(".") == 1:
                    cls = _owner(ctx, w)
                    meth = cls and next(
                        (m for m in cls.body if isinstance(m, ast.FunctionDef)
                         and m.name == d[5:]), None)
                    built = ([meth] if meth else
                             _built_with(ctx, cls, d[5:], funcs) if cls
                             else None)
                    if built is None:
                        cap.unresolved.append((n.lineno, d))
                        continue
                    for fn in built:
                        add(fn)
                        roots.append(fn.name)
        cap.sites.append((w.lineno, roots))
    # closure: what captured functions call inside this module
    todo = [fn for fn, _s in found.values()]
    while todo:
        fn = todo.pop()
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            if isinstance(n.func, ast.Name) and n.func.id in funcs:
                callee = funcs[n.func.id]
                if id(callee) not in found:
                    add(callee)
                    todo.append(callee)
            elif (isinstance(n.func, ast.Subscript)
                  and isinstance(n.func.value, ast.Name)
                  and n.func.value.id in tables):
                for name in tables[n.func.value.id]:
                    callee = funcs[name]
                    if id(callee) not in found:
                        add(callee)
                        todo.append(callee)
    cap.functions = sorted(found.values(), key=lambda p: p[0].lineno)
    return cap


class CapturePurity(Rule):
    name = "jit-purity"
    doc = ("captured functions stay pure: no `.item()`/`.tolist()`/"
           "`.cpu()`/`.numpy()` host syncs, no torch.cuda.synchronize, "
           "no numpy host ops, no Python branches on tensor params — a "
           "capture runs the host side once, so a replay either skips "
           "that work or the capture itself faults on the sync")

    HOST_SYNCS = frozenset({"item", "tolist", "cpu", "numpy"})
    SYNC_CALLS = frozenset({"torch.cuda.synchronize"})

    @staticmethod
    def _tracer_params(fn: ast.FunctionDef, statics: set[str]):
        """Param names that hold tensors under capture: not static, and
        not optional-None structure flags (default None ⇒ branching on
        them is a structural decision)."""
        args = list(fn.args.posonlyargs) + list(fn.args.args)
        defaults = [None] * (len(args) - len(fn.args.defaults)) \
            + list(fn.args.defaults)
        out = set()
        for a, d in zip(args, defaults):
            if a.arg in statics or a.arg == "self":
                continue
            if isinstance(d, ast.Constant) and d.value is None:
                continue
            out.add(a.arg)
        for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
            if a.arg in statics:
                continue
            if isinstance(d, ast.Constant) and d.value is None:
                continue
            out.add(a.arg)
        return out

    @staticmethod
    def _branch_names(test: ast.AST) -> set[str]:
        """Names a branch test DYNAMICALLY depends on: excludes
        `x is None` comparisons and names only reached through
        `len(...)` / `.shape` / `.ndim` / `.dtype` (static under
        capture)."""
        skip: set[int] = set()
        for n in ast.walk(test):
            if (isinstance(n, ast.Compare)
                    and all(isinstance(op, (ast.Is, ast.IsNot))
                            for op in n.ops)):
                skip.update(id(x) for x in ast.walk(n))
            if (isinstance(n, ast.Call) and _dotted(n.func) == "len"):
                skip.update(id(x) for x in ast.walk(n))
            if (isinstance(n, ast.Attribute)
                    and n.attr in ("shape", "ndim", "dtype", "size")):
                skip.update(id(x) for x in ast.walk(n))
        return {n.id for n in ast.walk(test)
                if isinstance(n, ast.Name) and id(n) not in skip}

    def _check(self, ctx, where: str, nodes, tracers: set) -> list:
        out = []
        for node in nodes:
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.HOST_SYNCS):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    f"host sync .{node.func.attr}() inside {where} — "
                    f"blocks dispatch and faults under capture"))
            elif (isinstance(node, ast.Call)
                    and _dotted(node.func) in self.SYNC_CALLS):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    f"device-wide {_dotted(node.func)}() inside "
                    f"{where} — a capture cannot synchronize"))
            elif (isinstance(node, ast.Call)
                    and _dotted(node.func).startswith("np.")):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    f"numpy host op {_dotted(node.func)}() inside "
                    f"{where} — runs on host once, not on device per "
                    f"replay"))
            elif isinstance(node, (ast.If, ast.While)):
                hot = self._branch_names(node.test) & tracers
                if hot:
                    out.append(Finding(
                        self.name, ctx.rel, node.lineno,
                        f"Python branch on tensor param(s) "
                        f"{sorted(hot)} inside {where} — a replay "
                        f"keeps the branch the capture took; branch "
                        f"on a static value or use torch.where"))
        return out

    def check_file(self, ctx: FileContext) -> list[Finding]:
        cap = captured_functions(ctx)
        out = []
        for fn, statics in cap.functions:
            out += self._check(ctx, f"captured function {fn.name}()",
                               ast.walk(fn),
                               self._tracer_params(fn, statics))
        for w in cap.bodies:
            nodes = [n for stmt in w.body
                     for n in [stmt, *_walk_no_defs(stmt)]]
            out += self._check(ctx, f"the capture at line {w.lineno}",
                               nodes, set())
        for line, call in cap.unresolved:
            out.append(Finding(
                self.name, ctx.rel, line,
                f"{call}() inside a CUDA-graph capture resolves to no "
                f"function of this module — capture a named function, "
                f"or an instance built from one, so R6/R13 can read "
                f"what the graph records"))
        return out


# ---------------------------------------------------------------------------
class ShardMapCompat(Rule):
    name = "shard-map-compat"
    doc = ("the mesh layer's collectives resolve ONLY through "
           "parallel/mesh.py (all_gather, psum, pmax, ppermute, "
           "psum_scatter, and the torch.distributed process group and "
           "calls that carry them across processes, the store of the "
           "lead's decisions among them): a direct `torch.distributed` "
           "reference or import anywhere else, a reach for that store "
           "(`mesh._DECISIONS`) past `mesh.agree`, or a `shard_map` "
           "spelling of the reference's, pins the layer to one backend "
           "and one version, so a change of either re-parks the mesh")

    SHIM = P + "parallel/mesh.py"
    # the module global that holds the store of the lead's decisions
    STORE = "_DECISIONS"

    def applies(self, rel: str) -> bool:
        return ((rel.startswith(P) or rel == BENCH_SCRIPT)
                and rel != self.SHIM)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        flagged: set[int] = set()  # one finding per line, not per
        #                            nested Attribute of the same chain

        def flag(line: int, what: str) -> None:
            if line in flagged:
                return
            flagged.add(line)
            out.append(Finding(
                self.name, ctx.rel, line,
                f"direct {what} outside parallel/mesh.py — reach "
                f"collectives through the mesh module"))

        for node in ctx.nodes():
            if isinstance(node, ast.Attribute):
                d = _dotted(node)
                if (d == "jax.shard_map"
                        or d.startswith("jax.experimental.shard_map")
                        or d == "torch.distributed"
                        or d.startswith("torch.distributed.")):
                    flag(node.lineno, f"`{d}` reference")
                elif node.attr == self.STORE:
                    flag(node.lineno, f"`{d or node.attr}` (the decision "
                                      f"store) reference")
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if any(a.name == self.STORE for a in node.names):
                    flag(node.lineno, f"import of `{self.STORE}` (the "
                                      f"decision store)")
                if (mod.startswith("jax.experimental.shard_map")
                        or mod.startswith("torch.distributed")
                        or (mod == "jax" and any(
                            a.name == "shard_map" for a in node.names))
                        or (mod == "torch" and any(
                            a.name == "distributed" for a in node.names))):
                    flag(node.lineno, f"import from `{mod}`")
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if (a.name.startswith("jax.experimental.shard_map")
                            or a.name.startswith("torch.distributed")):
                        flag(node.lineno, f"import of `{a.name}`")
        return out


# ---------------------------------------------------------------------------
class FusedHostCallback(Rule):
    name = "fused-host-callback"
    doc = ("R13: captured functions in the fused-program layer "
           "(engine/fused.py, ops/) keep host accounting OUT of the "
           "captured region — a costprofile/tracing/METRICS/deadline/"
           "flightrec/kbuild call inside runs once, at capture, and "
           "never on a replay; account around the replay, never inside "
           "it")

    SCOPES = (P + "ops/",)
    FUSED = P + "engine/fused.py"
    HOST_HELPERS = ("costprofile", "tracing", "METRICS", "deadline",
                    "flightrec", "kbuild")
    HOST_CALLS = frozenset({"jit_call", "note_launch", "launch_frame"})

    def applies(self, rel: str) -> bool:
        return rel.startswith(self.SCOPES) or rel == self.FUSED

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        aliases = import_aliases(ctx)
        cap = captured_functions(ctx)
        regions = [(f"captured function {fn.name}()", ast.walk(fn))
                   for fn, _s in cap.functions]
        regions += [(f"the capture at line {w.lineno}",
                     [n for stmt in w.body
                      for n in [stmt, *_walk_no_defs(stmt)]])
                    for w in cap.bodies]
        for where, nodes in regions:
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                d = _dotted(node.func)
                root = d.split(".", 1)[0]
                home = aliases.get(root, root).rsplit(".", 1)[-1]
                leaf = d.rsplit(".", 1)[-1]
                if (root in self.HOST_HELPERS or home in self.HOST_HELPERS
                        or leaf in self.HOST_CALLS):
                    out.append(Finding(
                        self.name, ctx.rel, node.lineno,
                        f"host accounting call {d}() inside {where} — "
                        f"it runs at capture only; move it outside the "
                        f"captured region (around the replay)"))
        return out


# ---------------------------------------------------------------------------
class AtomicWrite(Rule):
    name = "atomic-write"
    doc = ("persistence-layer files (store/, server/backup.py) must be "
           "written via the tmp+fsync+os.replace pattern "
           "(vault.atomic_write / write_bytes, or a function that "
           "itself fsyncs and replaces) — a kill mid-`open(..., 'w')` "
           "leaves a torn file where recovery expects a whole one")

    SCOPES = (P + "store/",)
    BACKUP = P + "server/backup.py"

    def applies(self, rel: str) -> bool:
        return rel.startswith(self.SCOPES) or rel == self.BACKUP

    @staticmethod
    def _atomic_spans(ctx: FileContext) -> list[tuple[int, int]]:
        """Line spans of functions that ARE the atomic pattern: they
        call both os.fsync and os.replace themselves, so their write
        handle is the tmp side of a replace."""
        lines = {"os.replace": [], "os.fsync": []}
        for n in ctx.nodes(ast.Call):
            got = lines.get(_dotted(n.func))
            if got is not None:
                got.append(n.lineno)
        spans = []
        for node in ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            lo, hi = node.lineno, node.end_lineno
            if all(any(lo <= x <= hi for x in xs) for xs in lines.values()):
                spans.append((lo, hi))
        return spans

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        spans = self._atomic_spans(ctx)
        for node in ctx.nodes():
            if not (isinstance(node, ast.Call)
                    and _dotted(node.func) == "open"):
                continue
            mode = None
            if len(node.args) >= 2 and isinstance(node.args[1],
                                                  ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value,
                                                   ast.Constant):
                    mode = kw.value.value
            if not (isinstance(mode, str) and mode.startswith("w")):
                continue  # reads/appends ("r", "rb", "ab", "r+b") pass
            if any(lo <= node.lineno <= hi for lo, hi in spans):
                continue
            out.append(Finding(
                self.name, ctx.rel, node.lineno,
                f"non-atomic file write open(..., {mode!r}) in the "
                f"persistence layer — route it through "
                f"vault.atomic_write/write_bytes (tmp+fsync+"
                f"os.replace), or waive with the reason a torn file "
                f"is safe here"))
        return out


# ---------------------------------------------------------------------------
class CacheRegistration(Rule):
    name = "cache-registration"
    doc = ("R14: byte-holding caches must join the process memory "
           "governor (utils/memgov.py) — every `Memo(...)` call "
           "carries an explicit `governed=` decision, and a file that "
           "creates a dict-typed `*_cache` attribute must call "
           "`memgov.GOVERNOR.register` somewhere (or waive with the "
           "reason its bytes are bounded); an unregistered cache is "
           "invisible to the OOM evict-retry path and /debug/memory")

    DICT_CTORS = frozenset({"dict", "OrderedDict",
                            "collections.OrderedDict"})
    # the governor itself and the Memo implementation are the
    # mechanism, not clients of it
    MECHANISM = (P + "utils/memgov.py", P + "utils/jitcache.py")

    def applies(self, rel: str) -> bool:
        return rel.startswith(P) and rel not in self.MECHANISM

    @staticmethod
    def _is_dict_value(node: ast.AST) -> bool:
        if isinstance(node, ast.Dict):
            return True
        return (isinstance(node, ast.Call)
                and _dotted(node.func)
                in CacheRegistration.DICT_CTORS)

    @staticmethod
    def _cache_targets(node: ast.stmt):
        """Attribute/name targets ending in `_cache` of an assignment
        whose value is a dict literal / dict() / OrderedDict()."""
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            return
        if not CacheRegistration._is_dict_value(value):
            return
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr.endswith("_cache"):
                yield t.attr
            elif isinstance(t, ast.Name) and t.id.endswith("_cache"):
                yield t.id

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        registers = any(
            isinstance(n, ast.Call)
            and _dotted(n.func).endswith("GOVERNOR.register")
            for n in ctx.nodes(ast.Call))
        for node in ctx.nodes():
            if (isinstance(node, ast.Call)
                    and _dotted(node.func).rsplit(".", 1)[-1] == "Memo"
                    and not any(kw.arg == "governed"
                                for kw in node.keywords)):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    "Memo(...) without an explicit governed= decision "
                    "— pass governed=\"<inventory name>\" to join the "
                    "memory governor, or governed=None with a waiver "
                    "stating why its bytes stay unbudgeted"))
            elif isinstance(node, ast.stmt) and not registers:
                for attr in self._cache_targets(node):
                    out.append(Finding(
                        self.name, ctx.rel, node.lineno,
                        f"dict-typed cache attribute `{attr}` in a "
                        f"file that never calls "
                        f"memgov.GOVERNOR.register — register its "
                        f"bytes/evict callbacks (GOVERNED_CACHES "
                        f"inventory), or waive with the bound that "
                        f"keeps it small"))
        return out


# ---------------------------------------------------------------------------
class SloSpec(Rule):
    name = "slo-spec"
    doc = ("R15: SLO objective names stay inside the utils/slo."
           "SLO_SPECS inventory — a literal `slo=` metric label, a "
           "literal SLO_SPECS/DEFAULT_TARGETS subscript, or a literal "
           "`_evaluator(\"...\")` registration outside the inventory "
           "splits the burn-rate vocabulary between dashboards, "
           "/debug/slo, and the watchdog's kind=slo conviction feed")

    SPEC_TABLES = frozenset({"SLO_SPECS", "DEFAULT_TARGETS"})

    def __init__(self):
        # utils/slo.py imports no torch, so the analyzer loads the
        # inventory itself
        from dgraph_tpu_torch.utils.slo import SLO_SPECS
        self.known = frozenset(SLO_SPECS)

    def applies(self, rel: str) -> bool:
        return rel.startswith(P) or rel == BENCH_SCRIPT

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []

        def flag(line: int, name: str, where: str) -> None:
            out.append(Finding(
                self.name, ctx.rel, line,
                f"SLO name {name!r} ({where}) is not in the "
                f"utils/slo.SLO_SPECS inventory — add it there with a "
                f"doc line (and an @_evaluator), or fix the literal; "
                f"known: {sorted(self.known)}"))

        for node in ctx.nodes():
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if (kw.arg == "slo"
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)
                            and kw.value.value not in self.known):
                        flag(node.lineno, kw.value.value,
                             "literal slo= label")
                if (_dotted(node.func).rsplit(".", 1)[-1]
                        == "_evaluator"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)
                        and node.args[0].value not in self.known):
                    flag(node.lineno, node.args[0].value,
                         "evaluator registration")
            elif (isinstance(node, ast.Subscript)
                    and _dotted(node.value).rsplit(".", 1)[-1]
                    in self.SPEC_TABLES
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                    and node.slice.value not in self.known):
                flag(node.lineno, node.slice.value, "spec-table lookup")
        return out


def default_rules() -> list[Rule]:
    from dgraph_tpu_torch.analysis.guards import guard_rules
    return [HotLoopCheckpoint(), DirectIO(), WallClock(),
            RetryDeadline(), MetricDocs(), CapturePurity(),
            ShardMapCompat(), FusedHostCallback(),
            AtomicWrite(), CacheRegistration(),
            SloSpec()] + guard_rules()
