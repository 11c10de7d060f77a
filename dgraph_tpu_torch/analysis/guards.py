"""graftrace: lock-discipline inference + rules R9-R12 (Eraser, static half).

Port of `dgraph_tpu/analysis/guards.py`, and the port's one copy of
the guarded-field inference: the race sanitizer (`utils/locks.py`
`guarded()` under `DGRAPH_TPU_RACE_SANITIZER=1`) arms exactly what
`runtime_inventory()` below returns, so the static and dynamic halves
cannot drift (`tests/test_torch_lint.py` pins the round trip).

Inference, per class:

* **lock attrs** — `self.X = locks.make_lock("name")` (and
  `make_rlock` / `make_condition`); an f-string's dynamic parts read as
  `*` (`admission.*`).
* **lock scopes** — `with self.X:` bodies, without descending into
  nested function definitions (a closure runs on another thread).
* **helper propagation** — a method called ONLY from inside lock-X
  scopes of its own class inherits X as held context (the "caller
  holds the lock" idiom), to a fixpoint.
* **lock hand-off** — a method handed as a callback in a call that also
  hands over `lock=self.X` runs under X (`memgov.govern_dict` calls its
  eviction callback holding the lock it was given). The port's addition:
  the reference has no such call.
* **writes** — rebinds (`self.F = …`, `self.F += …`), subscript
  stores/deletes (`self.F[k] = …`), and calls of known mutators
  (`self.F.append(…)`, `.update`, `.pop`, …). Everything else that
  touches `self.F` is a read.
* **discipline** — a field is guarded by lock X when it has ≥1 write
  under X AND at least 3/4 of its access sites hold X. The bar leaves
  out the atomic published pointer (a field rebound under a lock that
  serializes writers, read unlocked by readers that tolerate either
  snapshot).
* **init window** — `__init__`/`__del__`, and any method reachable
  ONLY from them, run before the object is shared and are exempt.

Rules (same waiver grammar, same CLI and gate as R1-R8):

R9  guarded-field          a field written under a lock must hold that
                           lock at EVERY access site in the class.
R10 guarded-escape         returning/yielding a bare reference to a
                           mutable guarded container from inside its
                           lock scope; return a copy or a snapshot.
R11 split-critical-section a read of a guarded field in one lock scope
                           feeding a write of it in a SEPARATE
                           acquisition within one function
                           (check-then-act across a lock release).
R12 untracked-lock         a `threading` Lock, RLock or Condition
                           made directly outside utils/locks.py,
                           where the port makes every lock.

A field whose R9 finding is WAIVED (reasoned benign) is also dropped
from `runtime_inventory()`, so one reviewed reason disarms both halves
for that field.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import pathlib

from dgraph_tpu_torch.analysis import PACKAGE, FileContext, Finding, Rule
from dgraph_tpu_torch.analysis.rules import (_dotted, _name_arg,
                                             _walk_no_defs)

__all__ = ["ClassGuards", "infer_module", "class_inventory",
           "runtime_inventory", "GuardedField", "GuardedEscape",
           "SplitCriticalSection", "UntrackedLock", "guard_rules"]

_LOCK_FACTORIES = {"make_lock": "lock", "make_rlock": "rlock",
                   "make_condition": "condition"}

# method calls that mutate their receiver: `self.F.append(x)` is a
# WRITE of F's guarded state even though the binding only loads
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "remove",
    "discard", "clear", "sort", "reverse", "rotate", "write"})

# container constructors: a field initialized from one of these is a
# mutable container whose reference must not escape its lock scope
_CONTAINER_CALLS = frozenset({
    "list", "dict", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "bytearray", "collections.deque",
    "collections.defaultdict", "collections.OrderedDict",
    "collections.Counter"})

_INIT_METHODS = ("__init__", "__del__", "__init_subclass__")

# the belief bar: a lock "protects" a field when at least 3/4 of the
# field's access sites hold it (and at least one of those is a write)
_BELIEF_NUM = 0.75


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _is_container_value(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        return d in _CONTAINER_CALLS or d.rsplit(".", 1)[-1] in (
            "deque", "defaultdict", "OrderedDict", "Counter")
    return False


@dataclasses.dataclass
class _Access:
    """One `self.F` touch: where, read or write, which lock scopes
    enclosed it (attr → id of the innermost `with` node per lock),
    and which method it sits in."""

    field: str
    write: bool
    line: int
    scopes: dict  # lock_attr -> id(with_node)
    method: str


@dataclasses.dataclass
class ClassGuards:
    """Everything the rules (and the runtime shim) need for one
    class."""

    name: str
    file: str
    line: int
    locks: dict          # lock attr -> order-class label
    accesses: list       # [_Access]
    containers: set      # fields initialized as mutable containers
    methods: set         # method names (to skip `self.m()` "reads")

    # filled by infer_module after the propagation fixpoints
    method_ctx: dict = dataclasses.field(default_factory=dict)
    init_exempt: set = dataclasses.field(default_factory=set)

    def held_at(self, acc: _Access) -> set:
        """Lock attrs effectively held at an access: direct `with`
        scopes plus the method's propagated caller context."""
        return set(acc.scopes) | self.method_ctx.get(acc.method, set())

    def in_init_window(self, acc: _Access) -> bool:
        return (acc.method in _INIT_METHODS
                or acc.method in self.init_exempt)

    def discipline(self) -> dict:
        """The inferred lock discipline: lock attr → {field:
        (locked_accesses, unlocked_accesses)} for every field that
        clears the belief bar. The unlocked minority are the R9
        findings and the sites the dynamic sanitizer would fire at."""
        per_field: dict = {}
        for a in self.accesses:
            if self.in_init_window(a):
                continue
            per_field.setdefault(a.field, []).append(a)
        out: dict = {x: {} for x in self.locks}
        for field, accs in per_field.items():
            for x in self.locks:
                locked = [a for a in accs if x in self.held_at(a)]
                unlocked = [a for a in accs if x not in self.held_at(a)]
                if not any(a.write for a in locked):
                    continue
                if len(locked) < _BELIEF_NUM * (len(locked)
                                                + len(unlocked)):
                    continue
                out[x][field] = (locked, unlocked)
        return out

    def guarded_fields(self) -> dict:
        """lock attr -> every field touched under it (read or
        write) — the superset R10/R11 key off."""
        out: dict = {x: set() for x in self.locks}
        for a in self.accesses:
            for x in self.held_at(a):
                out[x].add(a.field)
        return out


def _parents(fn: ast.AST) -> dict:
    par = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            par[id(child)] = node
    return par


def _classify(node: ast.Attribute, par: dict) -> bool:
    """Is this `self.F` node a WRITE of F's state? Rebinds, subscript
    stores/deletes through it, and mutator-method calls on it all
    count."""
    if isinstance(node.ctx, (ast.Store, ast.Del)):
        return True
    p = par.get(id(node))
    if (isinstance(p, ast.Subscript) and p.value is node
            and isinstance(p.ctx, (ast.Store, ast.Del))):
        return True
    if (isinstance(p, ast.Attribute) and p.value is node
            and p.attr in _MUTATORS):
        g = par.get(id(p))
        if isinstance(g, ast.Call) and g.func is p:
            return True
    return False


def _scan_method(fn: ast.FunctionDef, lock_attrs: set,
                 method_names: set, par: dict):
    """Walk one method, carrying the set of enclosing lock scopes
    (`par`: the module's parent map). Returns (accesses, call_sites)
    where call_sites is [(callee, scopes_dict)] for intra-class
    `self.m()` calls."""
    accesses: list[_Access] = []
    calls: list[tuple] = []

    def visit(node, scopes):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return  # another execution context (often another thread)
        if isinstance(node, ast.With):
            inner = dict(scopes)
            for item in node.items:
                ce = item.context_expr
                visit(ce, scopes)
                if item.optional_vars is not None:
                    visit(item.optional_vars, scopes)
                if _is_self_attr(ce) and ce.attr in lock_attrs:
                    inner[ce.attr] = id(node)
            for stmt in node.body:
                visit(stmt, inner)
            return
        if _is_self_attr(node):
            p = par.get(id(node))
            is_call = isinstance(p, ast.Call) and p.func is node
            if node.attr in lock_attrs:
                pass  # the lock itself, not guarded state
            elif is_call and node.attr in method_names:
                calls.append((node.attr, dict(scopes)))
            elif not node.attr.startswith("__"):
                accesses.append(_Access(
                    node.attr, _classify(node, par), node.lineno,
                    dict(scopes), fn.name))
        for child in ast.iter_child_nodes(node):
            visit(child, scopes)

    for stmt in fn.body:
        visit(stmt, {})
    return accesses, calls


def _handoffs(fn: ast.FunctionDef, cls: str, lock_attrs: set,
              method_names: set):
    """(method, {lock attr}) for each method of the class that `fn`
    hands as a callback to a call that also passes `lock=self.X`."""
    for node in _walk_no_defs(fn):
        if not isinstance(node, ast.Call):
            continue
        held = {kw.value.attr for kw in node.keywords
                if kw.arg == "lock" and _is_self_attr(kw.value)
                and kw.value.attr in lock_attrs}
        if not held:
            continue
        for v in [*node.args, *(kw.value for kw in node.keywords)]:
            if (isinstance(v, ast.Attribute) and v.attr in method_names
                    and _dotted(v.value) in ("self", cls)):
                yield v.attr, held


def infer_module(tree: ast.Module, rel: str,
                 par: dict | None = None) -> list[ClassGuards]:
    """Lock-discipline inference over every class of one module
    (nested classes are scanned too, under their own name). `par` is
    the module's parent map, when the caller has one."""
    out = []
    for cls in [n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef)]:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        locks: dict = {}
        containers: set = set()
        for fn in methods.values():
            for node in _walk_no_defs(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if not _is_self_attr(tgt):
                        continue
                    # container-ness: `self.F = <container literal/ctor>`
                    if _is_container_value(node.value):
                        containers.add(tgt.attr)
                    if (isinstance(node.value, ast.Call)
                            and _dotted(node.value.func).rsplit(".", 1)[-1]
                            in _LOCK_FACTORIES):
                        locks[tgt.attr] = _name_arg(node.value) or "?"
        if not locks:
            continue
        if par is None:
            par = _parents(tree)
        cg = ClassGuards(cls.name, rel, cls.lineno, locks, [],
                         containers, set(methods))
        call_sites: dict = {}   # callee -> [(caller, scope_lockset)]
        for name, fn in methods.items():
            accs, calls = _scan_method(fn, set(locks), set(methods), par)
            cg.accesses.extend(accs)
            for callee, scopes in calls:
                call_sites.setdefault(callee, []).append(
                    (name, set(scopes)))
            for callee, held in _handoffs(fn, cls.name, set(locks),
                                          set(methods)):
                call_sites.setdefault(callee, []).append(
                    ("<callback>", held))
        # init-window fixpoint FIRST: a method reachable ONLY from
        # __init__/__del__ (transitively) runs before the object is
        # shared — optimistic start, shrink to the fixed point
        exempt = {m for m in methods
                  if m in call_sites and m not in _INIT_METHODS}
        changed = True
        while changed:
            changed = False
            for m in list(exempt):
                if not all(c in _INIT_METHODS or c in exempt
                           for c, _held in call_sites[m]):
                    exempt.discard(m)
                    changed = True
        cg.init_exempt = exempt
        # helper-propagation fixpoint: ctx[m] = ∩ over call sites of
        # (locks held at the site ∪ ctx[caller]); methods with no
        # intra-class call site are entry points (ctx = ∅). Init-
        # window call sites are skipped (an __init__ caller cannot
        # race). Sets only shrink from the optimistic start, so this
        # converges.
        ctx = {m: (set(locks) if m in call_sites else set())
               for m in methods}
        for m in _INIT_METHODS:
            ctx[m] = set()  # constructors are entry points, always
        changed = True
        while changed:
            changed = False
            for m, sites in call_sites.items():
                if m in _INIT_METHODS:
                    continue
                live = [(c, held) for c, held in sites
                        if c not in _INIT_METHODS and c not in exempt]
                if not live:
                    continue  # init-only: covered by init_exempt
                new = set(locks)
                for caller, held in live:
                    new &= held | ctx.get(caller, set())
                if new != ctx[m]:
                    ctx[m] = new
                    changed = True
        cg.method_ctx = ctx
        out.append(cg)
    return out


def _guards(ctx: FileContext) -> list[ClassGuards]:
    """`infer_module` of one scanned file, computed once."""
    got = ctx.memo.get("guards")
    if got is None:
        got = ctx.memo["guards"] = infer_module(
            ctx.tree, ctx.rel, ctx.parents() if any(
                ctx.nodes(ast.ClassDef)) else None)
    return got


# ---------------------------------------------------------------------------
class GuardedField(Rule):
    name = "guarded-field"
    doc = ("a field the class demonstrably treats as lock-guarded "
           "(≥1 locked write, ≥3/4 of access sites locked) must hold "
           "that lock at EVERY access site — each unguarded minority "
           "site is a data race under the right interleaving; fix it "
           "or waive with the reason the access is benign "
           "(`__init__`-only methods and helpers called only under "
           "the lock are already exempt)")

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for cg in _guards(ctx):
            seen: set = set()
            for attr, fields in cg.discipline().items():
                for field, (locked, unlocked) in fields.items():
                    for a in unlocked:
                        key = (field, a.line)
                        if key in seen:
                            continue
                        seen.add(key)
                        kind = "write" if a.write else "read"
                        out.append(Finding(
                            self.name, ctx.rel, a.line,
                            f"{cg.name}.{field} is guarded by lock "
                            f"{cg.locks[attr]!r} (self.{attr}) at "
                            f"{len(locked)} of "
                            f"{len(locked) + len(unlocked)} sites, "
                            f"but this {kind} in {a.method}() does "
                            f"not hold it — a data race under the "
                            f"right interleaving"))
        return out


# ---------------------------------------------------------------------------
class GuardedEscape(Rule):
    name = "guarded-escape"
    doc = ("returning/yielding a bare reference to a mutable guarded "
           "container field (list/dict/set/deque) from inside its "
           "lock scope hands callers state they will read/mutate "
           "UNLOCKED — return a copy or build a snapshot under the "
           "lock instead")

    # wrappers that still escape the bare reference when returned
    _TRANSPARENT = (ast.Tuple, ast.List, ast.Set)

    def _escapes(self, node: ast.AST, par: dict) -> bool:
        """Does this self.F reference flow into a Return/Yield
        through nothing but container literals? (`list(self.F)`,
        `self.F[k]`, `len(self.F)` all break the chain — they copy,
        index, or aggregate.)"""
        cur = node
        while True:
            p = par.get(id(cur))
            if p is None:
                return False
            if isinstance(p, (ast.Return, ast.Yield)):
                return True
            if isinstance(p, self._TRANSPARENT):
                cur = p
                continue
            if isinstance(p, ast.Dict) and cur in p.values:
                cur = p
                continue
            return False

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        cgs = _guards(ctx)
        if not cgs:
            return out
        par = ctx.parents()
        sites: dict = {}     # (field, line) → self.F nodes, walk order
        for node in ctx.nodes(ast.Attribute):
            if _is_self_attr(node):
                sites.setdefault((node.attr, node.lineno), []).append(node)
        for cg in cgs:
            guarded = cg.guarded_fields()
            for a in cg.accesses:
                if a.write or a.field not in cg.containers:
                    continue
                holding = cg.held_at(a)
                if not holding:
                    continue
                if not any(a.field in guarded.get(x, ())
                           for x in holding):
                    continue
                if any(self._escapes(n, par)
                       for n in sites.get((a.field, a.line), ())):
                    out.append(Finding(
                        self.name, ctx.rel, a.line,
                        f"{cg.name}.{a.field} is a mutable "
                        f"guarded container whose reference "
                        f"escapes its lock scope via "
                        f"return/yield — callers touch it "
                        f"unlocked; return a copy/snapshot"))
        return out


# ---------------------------------------------------------------------------
class SplitCriticalSection(Rule):
    name = "split-critical-section"
    doc = ("a guarded field read in one lock scope and written in a "
           "SEPARATE acquisition of the same lock within one "
           "function is check-then-act across a lock release — the "
           "state can change between the sections; fuse them or "
           "revalidate under the second acquisition (and waive with "
           "which one applies)")

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for cg in _guards(ctx):
            by_method: dict = {}
            for a in cg.accesses:
                by_method.setdefault(a.method, []).append(a)
            for method, accs in by_method.items():
                if method in _INIT_METHODS:
                    continue
                for attr in cg.locks:
                    reads: dict = {}   # field -> first read line/scope
                    for a in sorted(accs, key=lambda x: x.line):
                        sid = a.scopes.get(attr)
                        if sid is None:
                            continue
                        if not a.write:
                            reads.setdefault(a.field, (a.line, sid))
                            continue
                        first = reads.get(a.field)
                        if first and first[1] != sid:
                            out.append(Finding(
                                self.name, ctx.rel, a.line,
                                f"{cg.name}.{a.field} read under "
                                f"{cg.locks[attr]!r} at line "
                                f"{first[0]} then written here in a "
                                f"SEPARATE acquisition — check-then-"
                                f"act across a lock release"))
                            reads.pop(a.field, None)
        return out


# ---------------------------------------------------------------------------
class UntrackedLock(Rule):
    name = "untracked-lock"
    doc = ("a `threading` Lock, RLock or Condition made directly "
           "outside utils/locks.py — only make_lock/make_rlock/"
           "make_condition locks are visible to the lock-order AND "
           "race sanitizers; an untracked lock guards nothing the "
           "tooling can check")

    HOME = PACKAGE + "/utils/locks.py"
    BANNED = frozenset({"threading.Lock", "threading.RLock",
                        "threading.Condition"})

    def applies(self, rel: str) -> bool:
        return rel.startswith(PACKAGE + "/") and rel != self.HOME

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        bare = {a.name for node in ctx.nodes(ast.ImportFrom)
                if node.module == "threading"
                for a in node.names}
        for node in ctx.nodes(ast.Call):
            d = _dotted(node.func)
            if d in self.BANNED or (
                    d in ("Lock", "RLock", "Condition") and d in bare):
                out.append(Finding(
                    self.name, ctx.rel, node.lineno,
                    f"direct {d}() outside utils/locks.py — use "
                    f"locks.make_lock/make_rlock/make_condition so "
                    f"the lock-order and race sanitizers can see it"))
        return out


def guard_rules() -> list[Rule]:
    return [GuardedField(), GuardedEscape(), SplitCriticalSection(),
            UntrackedLock()]


# ---------------------------------------------------------------------------
# the runtime contract: ONE inventory for facts.py AND utils/locks.py

def class_inventory(ctx: FileContext) -> list[dict]:
    """Per-(class, lock) guarded-field entries for one scanned file:
    the fields with ≥1 locked write whose every unguarded access is a
    REAL (unwaived) finding. A field with a waived R9 finding is
    dropped: the reviewed reason disarms the static AND dynamic halves
    together."""
    out = []
    for cg in _guards(ctx):
        disc = cg.discipline()
        for attr in sorted(cg.locks):
            tracked = []
            for field, (_locked, unlocked) in disc[attr].items():
                if any(ctx.waiver_for(GuardedField.name, a.line)
                       is not None for a in unlocked):
                    continue  # reviewed-benign: disarm both halves
                tracked.append(field)
            if not tracked:
                continue
            out.append({"class": cg.name, "file": cg.file,
                        "line": cg.line, "lock": cg.locks[attr],
                        "lock_attr": attr,
                        "fields": sorted(tracked)})
    return out


@functools.lru_cache(maxsize=1)
def runtime_inventory() -> dict:
    """(repo-relative file, class name) → {"locks": {lock attr:
    {"lock", "fields"}}} over the whole port: what `locks.guarded()`
    arms at runtime. Cached: one source scan per process, on the first
    armed `guarded()` call."""
    root = pathlib.Path(__file__).resolve().parents[2]
    inv: dict = {}
    for f in sorted((root / PACKAGE).rglob("*.py")):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(root).as_posix()
        try:
            ctx = FileContext(rel, f.read_text())
        except SyntaxError:  # pragma: no cover - the port parses clean
            continue
        for entry in class_inventory(ctx):
            key = (entry["file"], entry["class"])
            inv.setdefault(key, {"locks": {}})["locks"][
                entry["lock_attr"]] = {"lock": entry["lock"],
                                       "fields": tuple(entry["fields"])}
    return inv
