"""The guarded-field inventory the race sanitizer arms from.

`locks.guarded(obj, lock_name)` needs, for the object's class, the
fields its lock protects. The reference reads them from its static
analysis (`dgraph_tpu/analysis/guards.py`: `infer_module`,
`ClassGuards.discipline`, `runtime_inventory`); the port must not import
the reference, and its static analysis is a later item, so this module
keeps its own copy of that inference, scanning `dgraph_tpu_torch/`:

* a class's locks are its `self.X = make_lock(...)` / `make_rlock` /
  `make_condition` assignments, labelled by the name argument (an
  f-string's dynamic parts read as `*`);
* each `self.F` access is recorded with the `with self.X:` scopes around
  it, as a write when it rebinds F, stores or deletes through a
  subscript of it, or calls a mutating method on it;
* a private helper called only from lock scopes inherits their locks
  (a fixpoint over intra-class calls), and methods reachable only from
  `__init__` are the init window, never counted;
* a lock protects a field when at least one write holds it and it is
  held at three quarters or more of the field's access sites.

The scan runs once per process, on the first armed `guarded()` call.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import pathlib

_LOCK_FACTORIES = {"make_lock", "make_rlock", "make_condition"}

# method calls that mutate their receiver: `self.F.append(x)` is a
# WRITE of F's guarded state even though the binding only loads
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "remove",
    "discard", "clear", "sort", "reverse", "rotate", "write"})

_INIT_METHODS = ("__init__", "__del__", "__init_subclass__")
_BELIEF_NUM = 0.75


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _lock_label(call: ast.Call) -> str:
    if call.args:
        a = call.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
        if isinstance(a, ast.JoinedStr):
            return "".join(
                v.value if (isinstance(v, ast.Constant)
                            and isinstance(v.value, str)) else "*"
                for v in a.values)
    return "?"


@dataclasses.dataclass
class _Access:
    field: str
    write: bool
    scopes: frozenset   # lock attrs whose `with` encloses the access
    method: str


@dataclasses.dataclass
class ClassGuards:
    name: str
    file: str
    locks: dict          # lock attr -> order-class label
    accesses: list
    method_ctx: dict = dataclasses.field(default_factory=dict)
    init_exempt: set = dataclasses.field(default_factory=set)

    def held_at(self, acc: _Access) -> set:
        return set(acc.scopes) | self.method_ctx.get(acc.method, set())

    def discipline(self) -> dict:
        """lock attr -> the fields it protects (see module doc)."""
        per_field: dict = {}
        for a in self.accesses:
            if a.method in _INIT_METHODS or a.method in self.init_exempt:
                continue
            per_field.setdefault(a.field, []).append(a)
        out: dict = {x: [] for x in self.locks}
        for field, accs in per_field.items():
            for x in self.locks:
                locked = [a for a in accs if x in self.held_at(a)]
                if not any(a.write for a in locked):
                    continue
                if len(locked) < _BELIEF_NUM * len(accs):
                    continue
                out[x].append(field)
        return out


def _walk_no_defs(node: ast.AST):
    todo = list(ast.iter_child_nodes(node))
    while todo:
        n = todo.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(n))


def _is_write(node: ast.Attribute, par: dict) -> bool:
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


def _scan_method(fn: ast.FunctionDef, lock_attrs: set, methods: set):
    par = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            par[id(child)] = node
    accesses: list[_Access] = []
    calls: list[tuple] = []

    def visit(node, scopes):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return  # another execution context (often another thread)
        if isinstance(node, ast.With):
            inner = set(scopes)
            for item in node.items:
                ce = item.context_expr
                visit(ce, scopes)
                if item.optional_vars is not None:
                    visit(item.optional_vars, scopes)
                if _is_self_attr(ce) and ce.attr in lock_attrs:
                    inner.add(ce.attr)
            for stmt in node.body:
                visit(stmt, frozenset(inner))
            return
        if _is_self_attr(node):
            p = par.get(id(node))
            is_call = isinstance(p, ast.Call) and p.func is node
            if node.attr in lock_attrs:
                pass
            elif is_call and node.attr in methods:
                calls.append((node.attr, scopes))
            elif not node.attr.startswith("__"):
                accesses.append(_Access(node.attr, _is_write(node, par),
                                        scopes, fn.name))
        for child in ast.iter_child_nodes(node):
            visit(child, scopes)

    for stmt in fn.body:
        visit(stmt, frozenset())
    return accesses, calls


def infer_module(tree: ast.Module, rel: str) -> list[ClassGuards]:
    out = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        lock_attrs: dict = {}
        for fn in methods.values():
            for node in _walk_no_defs(fn):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                leaf = _dotted(node.value.func).rsplit(".", 1)[-1]
                if leaf not in _LOCK_FACTORIES:
                    continue
                for tgt in node.targets:
                    if _is_self_attr(tgt):
                        lock_attrs[tgt.attr] = _lock_label(node.value)
        if not lock_attrs:
            continue
        cg = ClassGuards(cls.name, rel, lock_attrs, [])
        call_sites: dict = {}   # callee -> [(caller, locks held)]
        for name, fn in methods.items():
            accs, calls = _scan_method(fn, set(lock_attrs), set(methods))
            cg.accesses.extend(accs)
            for callee, scopes in calls:
                call_sites.setdefault(callee, []).append((name, scopes))
        # init window: methods reachable only from the constructors
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
        # helpers inherit the locks held at every (non-init) call site
        ctx = {m: (set(lock_attrs) if m in call_sites else set())
               for m in methods}
        for m in _INIT_METHODS:
            ctx[m] = set()
        changed = True
        while changed:
            changed = False
            for m, sites in call_sites.items():
                if m in _INIT_METHODS:
                    continue
                live = [(c, held) for c, held in sites
                        if c not in _INIT_METHODS and c not in exempt]
                if not live:
                    continue
                new = set(lock_attrs)
                for caller, held in live:
                    new &= set(held) | ctx.get(caller, set())
                if new != ctx[m]:
                    ctx[m] = new
                    changed = True
        cg.method_ctx = ctx
        out.append(cg)
    return out


@functools.lru_cache(maxsize=1)
def runtime_inventory() -> dict:
    """(repo-relative file, class name) -> {"locks": {lock attr:
    {"lock": label, "fields": (...)}}} over the whole port."""
    pkg = pathlib.Path(__file__).resolve().parents[1]
    root = pkg.parent
    inv: dict = {}
    for f in sorted(pkg.rglob("*.py")):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(root).as_posix()
        try:
            tree = ast.parse(f.read_text(), filename=rel)
        except SyntaxError:
            continue
        for cg in infer_module(tree, rel):
            disc = cg.discipline()
            for attr in sorted(cg.locks):
                if not disc[attr]:
                    continue
                entry = inv.setdefault((rel, cg.name), {"locks": {}})
                entry["locks"][attr] = {"lock": cg.locks[attr],
                                        "fields": tuple(sorted(disc[attr]))}
    return inv
