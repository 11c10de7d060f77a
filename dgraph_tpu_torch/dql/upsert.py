"""Upsert blocks: `upsert { query {...} mutation [@if(...)] {...} ... }`.

Port of `dgraph_tpu/dql/upsert.py`, the same parser and substitution.
Reference parity: edgraph upsert semantics (`edgraph/server.go`
doQueryInUpsert + `dgo` upsert API, SURVEY L10): run the query at the
transaction's read timestamp, bind uid/value variables, evaluate each
mutation's `@if` condition over `len(var)`, substitute `uid(v)` /
`val(v)` into the N-Quads, and commit through the normal conflict path —
so two racing upserts on an `@upsert` predicate still collide at the
oracle.

This module only PARSES the block and performs substitution; execution
lives in server/api.py Alpha.upsert (it owns txns and the engine).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

MAX_EXPANSION = 100_000  # cartesian uid(v) expansion safety cap


class UpsertError(ValueError):
    pass


@dataclass
class CondNode:
    """@if condition tree: comparisons over len(var), and/or/not."""
    op: str                      # "cmp" | "and" | "or" | "not"
    cmp: str = ""                # eq/lt/le/gt/ge (op == "cmp")
    var: str = ""
    value: int = 0
    children: list = field(default_factory=list)


@dataclass
class UpsertMutation:
    cond: CondNode | None
    set_rdf: str = ""
    del_rdf: str = ""


@dataclass
class UpsertRequest:
    query_src: str
    mutations: list[UpsertMutation] = field(default_factory=list)


_UPSERT_HEAD = re.compile(r"^\s*upsert\s*\{", re.DOTALL)


def is_upsert(src: str) -> bool:
    return bool(_UPSERT_HEAD.match(src))


def _matching(src: str, open_idx: int) -> int:
    """Index just past the brace that closes src[open_idx] == '{'
    (string-literal aware)."""
    depth = 0
    i = open_idx
    while i < len(src):
        c = src[i]
        if c == '"':
            i += 1
            while i < len(src) and src[i] != '"':
                i += 2 if src[i] == "\\" else 1
        elif c == "<":  # IRIs in N-Quads may hold braces, skip them
            j = src.find(">", i)
            if j == -1:
                break
            i = j
        elif c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    raise UpsertError("unbalanced braces in upsert block")


def _parse_cond(text: str) -> CondNode:
    toks = re.findall(
        r"len|eq|lt|le|gt|ge|and|or|not|AND|OR|NOT|\(|\)|,|\d+|[A-Za-z_]\w*",
        text)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else ""

    def eat(t=None):
        nonlocal pos
        if t is not None and peek() != t:
            raise UpsertError(f"@if: expected {t!r}, got {peek()!r}")
        pos += 1
        return toks[pos - 1]

    def parse_or():
        node = parse_and()
        while peek().lower() == "or":
            eat()
            node = CondNode("or", children=[node, parse_and()])
        return node

    def parse_and():
        node = parse_unary()
        while peek().lower() == "and":
            eat()
            node = CondNode("and", children=[node, parse_unary()])
        return node

    def parse_unary():
        if peek().lower() == "not":
            eat()
            return CondNode("not", children=[parse_unary()])
        if peek() == "(":
            eat()
            node = parse_or()
            eat(")")
            return node
        cmp_op = eat()
        if cmp_op not in ("eq", "lt", "le", "gt", "ge"):
            raise UpsertError(f"@if: unknown comparator {cmp_op!r}")
        eat("(")
        eat("len")
        eat("(")
        var = eat()
        eat(")")
        eat(",")
        value = int(eat())
        eat(")")
        return CondNode("cmp", cmp=cmp_op, var=var, value=value)

    node = parse_or()
    if pos != len(toks):
        raise UpsertError(f"@if: trailing input {toks[pos:]}")
    return node


def eval_cond(node: CondNode | None, var_counts: dict[str, int]) -> bool:
    if node is None:
        return True
    if node.op == "cmp":
        n = var_counts.get(node.var, 0)
        return {"eq": n == node.value, "lt": n < node.value,
                "le": n <= node.value, "gt": n > node.value,
                "ge": n >= node.value}[node.cmp]
    if node.op == "not":
        return not eval_cond(node.children[0], var_counts)
    vals = [eval_cond(c, var_counts) for c in node.children]
    return all(vals) if node.op == "and" else any(vals)


def parse_upsert(src: str) -> UpsertRequest:
    """Split an upsert block into its query source and mutation parts."""
    m = _UPSERT_HEAD.match(src)
    if not m:
        raise UpsertError("not an upsert block")
    end = _matching(src, m.end() - 1)
    if src[end:].strip():
        raise UpsertError(f"trailing input after upsert block: "
                          f"{src[end:].strip()[:40]!r}")
    body = src[m.end():end - 1]

    query_src = None
    mutations: list[UpsertMutation] = []
    i = 0
    while i < len(body):
        mm = re.match(r"\s*(query|mutation)\b", body[i:])
        if not mm:
            if body[i:].strip():
                raise UpsertError(
                    f"expected query/mutation, got {body[i:].strip()[:40]!r}")
            break
        kind = mm.group(1)
        i += mm.end()
        cond = None
        if kind == "mutation":
            cm = re.match(r"\s*@if\s*\(", body[i:])
            if cm:
                # condition runs to ITS matching ')'
                start = i + cm.end() - 1
                depth, j = 0, start
                while j < len(body):
                    if body[j] == "(":
                        depth += 1
                    elif body[j] == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    j += 1
                cond = _parse_cond(body[start + 1:j])
                i = j + 1
        ob = body.find("{", i)
        if ob == -1:
            raise UpsertError(f"{kind} block missing '{{'")
        cb = _matching(body, ob)
        block = body[ob + 1:cb - 1]
        i = cb
        if kind == "query":
            if query_src is not None:
                raise UpsertError("multiple query blocks in upsert")
            query_src = "{" + block + "}"
        else:
            mutations.append(_parse_mutation(block, cond))
    if query_src is None:
        raise UpsertError("upsert block has no query")
    if not mutations:
        raise UpsertError("upsert block has no mutation")
    return UpsertRequest(query_src=query_src, mutations=mutations)


def _parse_mutation(block: str, cond) -> UpsertMutation:
    """A mutation body: bare N-Quads (implicit set) or set{}/delete{}."""
    set_rdf, del_rdf = [], []
    rest = block
    found = False
    while True:
        mm = re.search(r"\b(set|delete)\s*\{", rest)
        if not mm:
            break
        found = True
        ob = mm.end() - 1
        cb = _matching(rest, ob)
        part = rest[ob + 1:cb - 1]
        (set_rdf if mm.group(1) == "set" else del_rdf).append(part)
        rest = rest[:mm.start()] + rest[cb:]
    if not found:
        set_rdf.append(block)
    return UpsertMutation(cond=cond, set_rdf="\n".join(set_rdf),
                          del_rdf="\n".join(del_rdf))


_UID_FN = re.compile(r"uid\s*\(\s*([A-Za-z_]\w*)\s*\)")
_VAL_FN = re.compile(r"val\s*\(\s*([A-Za-z_]\w*)\s*\)")


def substitute(rdf: str, uid_vars: dict[str, list[int]],
               val_vars: dict[str, dict[int, object]]) -> str:
    """Expand uid(v)/val(v) in an N-Quads body (reference: `dgraph`
    upsert substitution). Each line expands over the cartesian product of
    its uid vars; `val(v)` takes the value bound to the line's expanded
    SUBJECT uid (subject must itself be a uid(var) reference then). Lines
    whose uid var is empty — or whose val(v) has no binding for the
    subject — drop out, as in the reference."""
    out = []
    for line in rdf.splitlines():
        if not line.strip():
            continue
        uvars = _UID_FN.findall(line)
        combos = [{}]
        for v in dict.fromkeys(uvars):  # unique, in order
            uids = uid_vars.get(v, [])
            if not uids:
                combos = []
                break
            combos = [dict(c, **{v: u}) for c in combos for u in uids]
            if len(combos) > MAX_EXPANSION:
                raise UpsertError(
                    f"uid() expansion exceeds {MAX_EXPANSION} lines")
        for combo in combos:
            ln = _UID_FN.sub(lambda m: f"<{combo[m.group(1)]:#x}>", line)
            if _VAL_FN.search(ln):
                # the line's subject uid drives every val() binding
                sm = re.match(r"\s*<(0[xX][0-9a-fA-F]+)>", ln)
                if sm is None:
                    raise UpsertError(
                        "val() needs a uid(var) subject on the same line")
                subj = int(sm.group(1), 16)
                missing = False

                def repl(m):
                    nonlocal missing
                    b = val_vars.get(m.group(1), {}).get(subj)
                    if b is None:
                        missing = True
                        return ""
                    # lambda replacement: the literal is inserted verbatim
                    # (a plain-string repl would re-interpret backslashes)
                    return _rdf_literal(b)

                ln = _VAL_FN.sub(repl, ln)
                if missing:
                    continue
            out.append(ln)
    return "\n".join(out)


_UID_ONLY = re.compile(r"^\s*uid\s*\(\s*([A-Za-z_]\w*)\s*\)\s*$")
_VAL_ONLY = re.compile(r"^\s*val\s*\(\s*([A-Za-z_]\w*)\s*\)\s*$")


def substitute_json(objs, uid_vars: dict[str, list[int]],
                    val_vars: dict[str, dict[int, object]]) -> list:
    """Expand uid(v)/val(v) inside a JSON mutation list (the Dgraph HTTP
    JSON upsert form: {"query": ..., "set": [{"uid": "uid(v)", ...}]}).

    A list item whose "uid" is "uid(v)" expands into one object per bound
    uid (dropping out when the var is empty); that uid becomes the
    subject for val(w) references in the item's fields. uid(v) strings in
    nested positions substitute only a single binding."""
    if isinstance(objs, dict):
        objs = [objs]
    out = []
    for item in objs:
        if not isinstance(item, dict):
            out.append(item)
            continue
        m = _UID_ONLY.match(str(item.get("uid", "")))
        if m:
            for u in uid_vars.get(m.group(1), []):
                d = _sub_tree({k: v for k, v in item.items()
                               if k != "uid"}, uid_vars, val_vars, u)
                d["uid"] = f"{u:#x}"
                out.append(d)
        else:
            out.append(_sub_tree(item, uid_vars, val_vars, None))
    return out


def _sub_tree(obj, uid_vars, val_vars, subj):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            r = _sub_tree(v, uid_vars, val_vars, subj)
            if r is not _MISSING:
                out[k] = r
        return out
    if isinstance(obj, list):
        return [r for r in (_sub_tree(v, uid_vars, val_vars, subj)
                            for v in obj) if r is not _MISSING]
    if isinstance(obj, str):
        m = _UID_ONLY.match(obj)
        if m:
            uids = uid_vars.get(m.group(1), [])
            if len(uids) != 1:
                raise UpsertError(
                    f"uid({m.group(1)}) in a nested position needs exactly "
                    f"one binding, got {len(uids)}")
            return f"{uids[0]:#x}"
        m = _VAL_ONLY.match(obj)
        if m:
            if subj is None:
                raise UpsertError(
                    'val() in JSON needs an enclosing {"uid": "uid(v)"} '
                    "object")
            b = val_vars.get(m.group(1), {}).get(subj)
            return _MISSING if b is None else b
    return obj


class _Missing:
    pass


_MISSING = _Missing()


def _rdf_literal(v) -> str:
    import numpy as np
    if isinstance(v, (bool, np.bool_)):
        return f'"{str(bool(v)).lower()}"^^<xs:boolean>'
    if isinstance(v, (int, np.integer)):
        return f'"{int(v)}"^^<xs:int>'
    if isinstance(v, (float, np.floating)):
        return f'"{float(v)}"^^<xs:float>'
    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'
