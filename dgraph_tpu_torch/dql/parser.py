"""DQL parser: query text → SubGraph IR.

Port of `dgraph_tpu/dql/parser.py`, kept line-for-line: the whole
grammar is host code, so the port parses every shape the reference
does and the later slices' engines consume the same IR.

Reference parity: `gql/parser.go` (Parse → GraphQuery AST; here we go
straight to the engine IR since the AST↔SubGraph translation step of the
reference buys nothing in a from-scratch build).

Supported surface (the DQL subset per SURVEY §7, growing):
  blocks         name(func: ...) / var(func: ...) / x as name(...) /
                 shortest(from:, to:, numpaths:, depth:)
  root args      func, first, offset, after, orderasc, orderdesc
  functions      eq le lt ge gt between uid uid_in has type anyofterms
                 allofterms anyoftext alloftext regexp match,
                 eq(count(pred), N), eq(val(x), v)
  directives     @filter(AND/OR/NOT tree) @recurse(depth, loop) @cascade
                 @normalize @groupby
  fields         uid, pred, pred@lang, ~pred, alias: pred, x as pred,
                 count(pred), count(uid), val(x), min/max/sum/avg(val(x)),
                 math(expr), expand(_all_|Type), nested blocks with
                 (first/offset/after/orderasc/orderdesc) args
  query vars     query Q($a: string = "d") { ... } with $a substitution
"""

from __future__ import annotations

from dgraph_tpu_torch.dql.lexer import Token, tokenize
from dgraph_tpu_torch.engine.ir import (
    FilterNode, FuncNode, MsgPassArgs, Order, RecurseArgs, ShortestArgs,
    SubGraph,
)
from dgraph_tpu_torch.engine.mathexpr import BINOPS, UNOPS, MathTree

AGG_FUNCS = ("min", "max", "sum", "avg")


class ParseError(ValueError):
    pass


def parse(src: str, variables: dict | None = None) -> list[SubGraph]:
    return Parser(tokenize(src), variables or {}).parse_request()


def parse_schema_query(src: str):
    """`schema {}` / `schema(pred: [a, b]) { predicate type ... }` →
    (pred_filter | None, field_filter | None), or None when `src` is not
    a schema query (reference: the schema{} introspection request the
    gql parser special-cases)."""
    toks = tokenize(src)
    p = Parser(toks, {})
    if p.peek().text != "schema":
        return None
    p.next()
    preds = None
    if p.accept("("):
        p.expect("pred")
        p.expect(":")
        preds = []
        if p.accept("["):
            while not p.accept("]"):
                preds.append(p.name())
                p.accept(",")
        else:
            preds.append(p.name())
        p.expect(")")
    fields = None
    p.expect("{")
    while not p.accept("}"):
        if fields is None:
            fields = []
        fields.append(p.name())
    if p.peek().kind != "eof":
        raise ParseError("trailing input after schema query")
    return preds, fields


class Parser:
    def __init__(self, toks: list[Token], variables: dict):
        self.toks = toks
        self.i = 0
        self.vars = dict(variables)

    # -- token plumbing -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind == "eof":
            # consuming past the end is always a malformed query; raising
            # here kills the whole class of unterminated-input hangs
            raise ParseError(f"unexpected end of input at {t.pos}")
        self.i += 1
        return t

    def accept(self, text: str) -> bool:
        if self.peek().text == text:
            self.next()
            return True
        return False

    def expect(self, text: str) -> Token:
        t = self.next()
        if t.text != text:
            raise ParseError(f"expected {text!r}, got {t.text!r} at {t.pos}")
        return t

    def name(self) -> str:
        t = self.next()
        if t.kind != "name":
            raise ParseError(f"expected name, got {t.text!r} at {t.pos}")
        return _clean_name(t.text)

    # -- request ------------------------------------------------------------
    def parse_request(self) -> list[SubGraph]:
        if self.peek().text == "query":
            self._parse_var_decls()
        self.expect("{")
        blocks = []
        seen_names: set[str] = set()
        while not self.accept("}"):
            b = self.parse_block()
            # duplicate result names would silently shadow each other in the
            # JSON object ("var" and "shortest" blocks don't emit results)
            if b.alias not in ("var", "shortest"):
                if b.alias in seen_names:
                    raise ParseError(f"duplicate block name {b.alias!r}")
                seen_names.add(b.alias)
            blocks.append(b)
        t = self.peek()
        if t.kind != "eof":
            raise ParseError(f"unexpected trailing input {t.text!r} at {t.pos}")
        return blocks

    def _parse_var_decls(self) -> None:
        self.next()  # 'query'
        if self.peek().kind == "name" and self.peek().text != "{":
            self.next()  # query name
        if self.accept("("):
            while not self.accept(")"):
                var = self.name()  # $x
                self.expect(":")
                self.name()  # type
                if self.accept("="):
                    t = self.next()
                    if var not in self.vars:
                        self.vars[var] = _unquote(t)
                self.accept(",")

    def _subst(self, text: str):
        if text.startswith("$"):
            if text not in self.vars:
                raise ParseError(f"undefined query variable {text}")
            return self.vars[text]
        return text

    # -- blocks -------------------------------------------------------------
    def parse_block(self) -> SubGraph:
        sg = SubGraph()
        name = self.name()
        if self.peek().text == "as":
            self.next()
            sg.var_name = name
            name = self.name()
        sg.alias = name
        if name == "var":
            sg.is_internal = True
        if name == "shortest":
            sg.shortest = self._parse_shortest_args()
        else:
            self.expect("(")
            self._parse_root_args(sg)
            self.expect(")")
        self._parse_directives(sg)
        self.expect("{")
        self._parse_fields(sg)
        return sg

    def _parse_shortest_args(self) -> ShortestArgs:
        args = ShortestArgs()
        self.expect("(")
        while not self.accept(")"):
            key = self.name()
            self.expect(":")
            t = self.next()
            val = self._subst(t.text)
            if key == "from":
                args.from_uid = _parse_uid(val)
            elif key == "to":
                args.to_uid = _parse_uid(val)
            elif key == "numpaths":
                args.numpaths = int(val)
            elif key == "depth":
                args.depth = int(val)
            elif key == "minweight":
                args.minweight = float(val)
            elif key == "maxweight":
                args.maxweight = float(val)
            else:
                raise ParseError(f"unknown shortest arg {key!r}")
            self.accept(",")
        return args

    def _parse_root_args(self, sg: SubGraph) -> None:
        while self.peek().text != ")":
            key = self.name()
            self.expect(":")
            if key == "func":
                sg.func = self.parse_func()
            elif key in ("first", "offset"):
                setattr(sg, key, int(self._subst(self.next().text)))
            elif key == "after":
                sg.after = _parse_uid(self._subst(self.next().text))
            elif key in ("orderasc", "orderdesc"):
                sg.orders.append(self._parse_order(desc=key == "orderdesc"))
            else:
                raise ParseError(f"unknown root argument {key!r}")
            self.accept(",")

    def _parse_order(self, desc: bool) -> Order:
        t = self.peek()
        if t.text == "val":
            self.next()
            self.expect("(")
            var = self.name()
            self.expect(")")
            return Order(attr=var, desc=desc, is_val_var=True)
        attr, lang = self._attr_with_lang()
        return Order(attr=attr, desc=desc, lang=lang)

    def _attr_with_lang(self) -> tuple[str, str]:
        attr = self.name()
        lang = ""
        if attr == "@" or (self.peek().text == "@"):
            self.next()
            lang = self._lang_chain()
        return attr, lang

    def _lang_chain(self, allow_star: bool = False) -> str:
        if self.peek().text == "*":
            # `name@*` is an OUTPUT form: every language, keyed per tag.
            # In function args / order specs it would silently match no
            # value column, so it is rejected there.
            if not allow_star:
                raise ParseError(
                    f"@* is only valid on selection fields "
                    f"(at {self.peek().pos})")
            self.next()
            return "*"
        if self.accept("."):
            parts = ["."]       # bare `name@.`: any language
        else:
            parts = [self.name()]
        while self.accept(":"):
            if self.accept("."):
                parts.append(".")
            elif self.peek().kind == "name":
                parts.append(self.name())
            else:
                parts.append(".")
        return ":".join(parts)

    # -- functions ----------------------------------------------------------
    def parse_func(self) -> FuncNode:
        fname = self.name().lower()
        f = FuncNode(name=fname)
        self.expect("(")
        if fname == "uid":
            while not self.accept(")"):
                t = self.next()
                v = self._subst(t.text)
                if isinstance(v, str) and _is_uid_literal(v):
                    f.uids.append(_parse_uid(v))
                else:
                    f.args.append(v)  # uid variable name
                self.accept(",")
            return f
        if fname == "uid_in":
            f.attr = self.name()
            self.expect(",")
            while not self.accept(")"):
                f.uids.append(_parse_uid(self._subst(self.next().text)))
                self.accept(",")
            return f
        # first argument: attr | count(attr) | val(var)
        t = self.peek()
        if t.text == "count":
            self.next()
            self.expect("(")
            f.is_count = True
            f.attr = ("~" if self.accept("~") else "") + self.name()
            self.expect(")")
        elif t.text == "val":
            self.next()
            self.expect("(")
            f.is_val_var = True
            f.attr = self.name()
            self.expect(")")
        elif fname == "type":
            f.args.append(self.name())
            self.expect(")")
            return f
        else:
            f.attr, f.lang = self._attr_with_lang()
        while not self.accept(")"):
            self.expect(",")  # args after the first are comma-separated
            if self.peek().text == ")":
                continue  # tolerate trailing comma
            t = self.next()
            if t.kind == "string":
                f.args.append(_unquote(t))
            elif t.kind == "regex":
                body, _, flags = t.text.rpartition("/")
                f.args.extend([body[1:], flags])
            elif t.kind == "number":
                f.args.append(_parse_number(t.text))
            elif t.text == "[":
                # nested numeric array — geo coordinates:
                # near(loc, [lon, lat], d), within(loc, [[[...]]])
                f.args.append(self._parse_array())
            else:
                v = self._subst(t.text)
                f.args.append(v)
        _check_arity(f)
        return f

    def _parse_array(self):
        """JSON-style nested array of numbers; opening '[' consumed."""
        out = []
        while not self.accept("]"):
            if out:
                self.expect(",")
                if self.peek().text == "]":  # trailing comma
                    continue
            t = self.next()
            if t.text == "[":
                out.append(self._parse_array())
            elif t.kind == "number":
                out.append(_parse_number(t.text))
            else:
                raise ParseError(
                    f"expected number or '[' in array, got {t.text!r} "
                    f"at {t.pos}")
        return out

    # -- filter trees -------------------------------------------------------
    def parse_filter(self) -> FilterNode:
        self.expect("(")
        tree = self._filter_or()
        self.expect(")")
        return tree

    def _filter_or(self) -> FilterNode:
        left = self._filter_and()
        while self.peek().text.lower() == "or":
            self.next()
            right = self._filter_and()
            if left.op == "or":
                left.children.append(right)
            else:
                left = FilterNode(op="or", children=[left, right])
        return left

    def _filter_and(self) -> FilterNode:
        left = self._filter_not()
        while self.peek().text.lower() == "and":
            self.next()
            right = self._filter_not()
            if left.op == "and":
                left.children.append(right)
            else:
                left = FilterNode(op="and", children=[left, right])
        return left

    def _filter_not(self) -> FilterNode:
        if self.peek().text.lower() == "not":
            self.next()
            return FilterNode(op="not", children=[self._filter_not()])
        if self.peek().text == "(":
            self.next()
            tree = self._filter_or()
            self.expect(")")
            return tree
        return FilterNode(op="leaf", func=self.parse_func())

    # -- directives ---------------------------------------------------------
    def _parse_directives(self, sg: SubGraph) -> None:
        while self.accept("@"):
            d = self.name()
            if d == "filter":
                sg.filters = self.parse_filter()
            elif d == "recurse":
                sg.recurse = self._parse_recurse_args()
            elif d == "msgpass":
                sg.msgpass = self._parse_msgpass_args()
            elif d == "cascade":
                if self.accept("("):
                    fields = []
                    while not self.accept(")"):
                        fields.append(self.name())
                        self.accept(",")
                    sg.cascade = fields or ["__all__"]
                else:
                    sg.cascade = ["__all__"]
            elif d == "normalize":
                sg.normalize = True
            elif d == "groupby":
                self.expect("(")
                while not self.accept(")"):
                    sg.groupby.append(self.name())
                    self.accept(",")
            elif d == "facets":
                self._parse_facets_args(sg)
            else:
                raise ParseError(f"unknown directive @{d}")

    def _parse_facets_args(self, sg: SubGraph) -> None:
        """@facets | @facets(k1, a: k2) | @facets(eq(k, v) ...) |
        @facets(orderasc: k). Multiple @facets directives accumulate
        (reference: one for keys, one for filters, one for order). Only the
        bare/key forms request facet OUTPUT (facet_keys); the filter and
        order forms alone do not."""
        def want_output():
            if sg.facet_keys is None:
                sg.facet_keys = []

        if not self.accept("("):
            want_output()
            return  # bare @facets → all keys
        if self.peek().text == ")":
            self.next()
            want_output()
            return
        # filter form: a function name followed by "("
        if self.peek(1).text == "(" and self.peek().text.lower() in (
                "eq", "le", "lt", "ge", "gt", "not", "and", "or"):
            tree = self._filter_or()
            self.expect(")")
            sg.facet_filter = tree if sg.facet_filter is None else \
                FilterNode(op="and", children=[sg.facet_filter, tree])
            return
        while True:
            name = self.name()
            if name in ("orderasc", "orderdesc") and self.accept(":"):
                sg.facet_orders.append(Order(
                    attr=self.name(), desc=(name == "orderdesc")))
            elif self.peek().text == "as":
                # `v as key`: bind facet values to a value variable
                # keyed by CHILD uid (reference: facet variables);
                # binding alone does not request output
                self.next()
                if sg.facet_vars is None:
                    sg.facet_vars = []
                sg.facet_vars.append((name, self.name()))
            elif self.accept(":"):
                want_output()
                sg.facet_keys.append((name, self.name()))  # alias: key
            else:
                want_output()
                sg.facet_keys.append(("", name))
            if not self.accept(","):
                break
        self.expect(")")

    def _parse_recurse_args(self) -> RecurseArgs:
        args = RecurseArgs()
        if self.accept("("):
            while not self.accept(")"):
                key = self.name()
                self.expect(":")
                val = str(self._subst(self.next().text))
                if key == "depth":
                    args.depth = int(val)
                elif key == "loop":
                    args.loop = val.lower() == "true"
                else:
                    raise ParseError(f"unknown recurse arg {key!r}")
                self.accept(",")
        return args

    def _parse_msgpass_args(self) -> MsgPassArgs:
        """@msgpass(pred: emb, agg: mean): neighbour-feature
        aggregation bound at this level (engine/feat.py). `pred` is
        required; `agg` defaults to mean."""
        args = MsgPassArgs()
        if self.accept("("):
            while not self.accept(")"):
                key = self.name()
                self.expect(":")
                val = str(self._subst(self.next().text))
                if key == "pred":
                    args.pred = val
                elif key == "agg":
                    if val not in ("sum", "mean", "max"):
                        raise ParseError(
                            f"msgpass agg must be sum|mean|max, "
                            f"got {val!r}")
                    args.agg = val
                else:
                    raise ParseError(f"unknown msgpass arg {key!r}")
                self.accept(",")
        if not args.pred:
            raise ParseError("@msgpass requires a pred: argument")
        return args

    # -- fields -------------------------------------------------------------
    def _parse_fields(self, parent: SubGraph) -> None:
        while not self.accept("}"):
            parent.children.append(self._parse_field())

    def _parse_field(self) -> SubGraph:
        sg = SubGraph()
        tok = self.peek()
        name = _clean_name(tok.text)

        # alias / var prefix
        if tok.kind == "name" and self.peek(1).text == ":" and \
                self.peek(2).text != ")":
            self.next()
            self.expect(":")
            sg.alias = name
            name = _clean_name(self.peek().text)
        elif tok.kind == "name" and self.peek(1).text == "as":
            self.next()
            self.next()
            sg.var_name = name
            name = _clean_name(self.peek().text)

        if name == "uid" and self.peek(1).text != "(":
            self.next()
            sg.is_uid_leaf = True
            return sg
        if name == "count":
            self.next()
            self.expect("(")
            if self.accept("uid"):
                sg.is_count = True
                sg.is_uid_leaf = True
            else:
                sg.is_reverse = self.accept("~")
                sg.attr, sg.lang = self._attr_with_lang()
                if sg.attr.startswith("~"):
                    sg.is_reverse = True
                    sg.attr = sg.attr[1:]
                sg.is_count = True
            self.expect(")")
            return sg
        if name == "val":
            self.next()
            self.expect("(")
            sg.attr = self.name()
            sg.is_val_leaf = True
            self.expect(")")
            return sg
        if name == "checkpwd":
            # checkpwd(pred, "password") — verify against the stored
            # password hash (reference: password scalar + checkpwd)
            self.next()
            self.expect("(")
            sg.attr = self.name()
            self.expect(",")
            t = self.next()
            if t.kind != "string":
                raise ParseError(
                    f"checkpwd needs a quoted password at {t.pos}")
            sg.checkpwd_val = _unquote(t)
            self.expect(")")
            return sg
        if name in AGG_FUNCS and self.peek(1).text == "(":
            self.next()
            self.expect("(")
            self.expect("val")
            self.expect("(")
            sg.attr = self.name()
            self.expect(")")
            self.expect(")")
            sg.is_agg = True
            sg.agg_func = name
            return sg
        if name == "math":
            self.next()
            self.expect("(")
            sg.math_expr = self._parse_math_expr()
            self.expect(")")
            return sg
        if name == "expand":
            self.next()
            self.expect("(")
            sg.is_expand_all = True
            sg.expand_arg = self.name()
            self.expect(")")
            if self.accept("{"):
                self._parse_fields(sg)
            return sg

        # plain predicate (possibly reverse, possibly nested)
        if self.accept("~"):
            sg.is_reverse = True
            sg.attr = self.name()
        else:
            t = self.next()
            if t.kind != "name":
                raise ParseError(f"expected field, got {t.text!r} at {t.pos}")
            attr = _clean_name(t.text)
            if attr.startswith("~"):
                sg.is_reverse = True
                attr = attr[1:]
            sg.attr = attr
        if self.peek().text == "@" and \
                (self.peek(1).text in (".", "*") or
                 (self.peek(1).kind == "name" and
                  self.peek(1).text not in ("filter", "recurse", "cascade",
                                            "normalize", "groupby",
                                            "facets"))):
            self.next()
            sg.lang = self._lang_chain(allow_star=not sg.var_name)
        if self.accept("("):
            self._parse_child_args(sg)
        self._parse_directives(sg)
        if self.accept("{"):
            self._parse_fields(sg)
        return sg

    def _parse_child_args(self, sg: SubGraph) -> None:
        while not self.accept(")"):
            key = self.name()
            self.expect(":")
            if key in ("first", "offset"):
                setattr(sg, key, int(self._subst(self.next().text)))
            elif key == "after":
                sg.after = _parse_uid(self._subst(self.next().text))
            elif key in ("orderasc", "orderdesc"):
                sg.orders.append(self._parse_order(desc=key == "orderdesc"))
            else:
                raise ParseError(f"unknown field argument {key!r}")
            self.accept(",")

    # -- math ---------------------------------------------------------------
    def _parse_math_expr(self, min_prec: int = 0) -> MathTree:
        left = self._math_primary()
        while True:
            t = self.peek()
            if t.kind == "number" and t.text.startswith("-"):
                # "a-8": the lexer glued binary minus onto the literal
                prec = _MATH_PREC["-"]
                if prec < min_prec:
                    return left
                self.next()
                right = MathTree(op="const", const=_parse_number(t.text[1:]))
                left = MathTree(op="-", children=[left, right])
                continue
            prec = _MATH_PREC.get(t.text)
            if prec is None or prec < min_prec:
                return left
            self.next()
            right = self._parse_math_expr(prec + 1)
            left = MathTree(op=t.text, children=[left, right])

    def _math_primary(self) -> MathTree:
        t = self.next()
        if t.text == "(":
            e = self._parse_math_expr()
            self.expect(")")
            return e
        if t.text == "-":
            return MathTree(op="u-", children=[self._math_primary()])
        if t.kind == "number":
            return MathTree(op="const", const=_parse_number(t.text))
        if t.kind == "name":
            name = t.text
            if self.peek().text == "(":
                self.next()
                args = []
                while not self.accept(")"):
                    args.append(self._parse_math_expr())
                    self.accept(",")
                if name == "cond":
                    return MathTree(op="cond", children=args)
                if name == "val":
                    return MathTree(op="var", var=args[0].var or str(args[0].const))
                if name in UNOPS:
                    return MathTree(op=name, children=args)
                if name in BINOPS:
                    return MathTree(op=name, children=args)
                raise ParseError(f"unknown math function {name!r}")
            return MathTree(op="var", var=name)
        raise ParseError(f"bad math expression at {t.pos}")


_MATH_PREC = {"||": 1, "&&": 2, "==": 3, "!=": 3, "<": 3, ">": 3, "<=": 3,
              ">=": 3, "+": 4, "-": 4, "*": 5, "/": 5, "%": 5}


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "/": "/"}


_ARITY = {  # args after the attr: (min, max)
    "between": (2, 2), "le": (1, 1), "lt": (1, 1), "ge": (1, 1),
    "gt": (1, 1), "eq": (1, 10**9), "anyofterms": (1, 10**9),
    "allofterms": (1, 10**9), "regexp": (1, 2), "match": (1, 2),
    "has": (0, 0),
    "near": (2, 2), "within": (1, 1), "contains": (1, 1),
    "similar_to": (2, 2),  # k, <vector literal | uid>
}


def _check_arity(f) -> None:
    lim = _ARITY.get(f.name)
    if lim is None:
        return
    lo, hi = lim
    if not lo <= len(f.args) <= hi:
        want = str(lo) if lo == hi else f"{lo}..{hi}"
        raise ParseError(
            f"{f.name}() takes {want} argument(s) after the attribute, "
            f"got {len(f.args)}")


def _unquote(t: Token) -> str:
    s = t.text
    if t.kind == "string":
        import re as _re
        return _re.sub(r"\\(.)",
                       lambda m: _ESCAPES.get(m.group(1), m.group(1)),
                       s[1:-1])
    return s


def _clean_name(text: str) -> str:
    """Strip IRI angle brackets, preserving a leading '~' (reverse marker):
    '~<friend>' → '~friend', '<p>' → 'p'."""
    if text.startswith("~"):
        return "~" + text[1:].strip("<>")
    return text.strip("<>")


def _is_uid_literal(s: str) -> bool:
    if s.startswith(("0x", "0X")):
        return True
    return s.isdigit()


def _parse_uid(v) -> int:
    if isinstance(v, int):
        return v
    s = str(v)
    return int(s, 16) if s.startswith(("0x", "0X")) else int(s)


def _parse_number(s: str):
    if s.startswith(("0x", "0X")):
        return int(s, 16)
    if any(c in s for c in ".eE"):
        return float(s)
    return int(s)
