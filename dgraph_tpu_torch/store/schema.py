"""Predicate schema: types, directives, schema-language parser.

Port of `dgraph_tpu/store/schema.py`, unchanged: `to_text` of either
package's schema parses to the same `PredicateSchema`s in the other,
which is how `store.store_from_arrays` carries a schema across.

Reference parity: `schema/schema.go` (State: per-predicate type +
directives), `schema/parse.go` (the schema mutation language accepted by
Alter), including type definitions used by `dgraph.type` / `expand(_all_)`.

Grammar (the subset the reference's Alter accepts, minus enterprise):

    <pred>: <type> [@index(tok1, tok2)] [@reverse] [@count] [@lang]
            [@upsert] [@unique] .
    type <Name> { <pred1> <pred2> ... }

where <type> is one of uid|int|float|string|bool|datetime|password|geo|default,
optionally wrapped in [] for list-valued predicates.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from dgraph_tpu_torch.store.tok import TOKENIZERS
from dgraph_tpu_torch.store.types import Kind


@dataclass
class PredicateSchema:
    name: str
    kind: Kind = Kind.DEFAULT
    is_list: bool = False
    index_tokenizers: tuple[str, ...] = ()
    reverse: bool = False
    count: bool = False
    lang: bool = False
    upsert: bool = False
    unique: bool = False
    # float32vector only: embedding width. 0 = infer from the first
    # loaded vector; any later mismatch is refused at schema time.
    vector_dim: int = 0

    @property
    def is_uid(self) -> bool:
        return self.kind == Kind.UID

    @property
    def indexed(self) -> bool:
        return bool(self.index_tokenizers)


@dataclass
class TypeDef:
    name: str
    fields: tuple[str, ...] = ()


@dataclass
class Schema:
    """Mutable schema state (reference: schema.State())."""

    predicates: dict[str, PredicateSchema] = field(default_factory=dict)
    types: dict[str, TypeDef] = field(default_factory=dict)

    def get(self, pred: str) -> PredicateSchema:
        """Schema for a predicate; unknown predicates get a mutable default
        entry (the reference auto-creates schema on first mutation)."""
        if pred not in self.predicates:
            self.predicates[pred] = PredicateSchema(name=pred)
        return self.predicates[pred]

    def peek(self, pred: str) -> PredicateSchema | None:
        return self.predicates.get(pred)

    def clone(self) -> "Schema":
        """Deep copy, so a new Store snapshot's schema can evolve without
        mutating the one frozen into the previous snapshot."""
        import copy
        return copy.deepcopy(self)

    def update(self, other: "Schema") -> None:
        """Merge an Alter's schema into the live state (reference:
        Schema.Update — later declarations replace earlier per predicate)."""
        self.predicates.update(other.predicates)
        self.types.update(other.types)

    def to_text(self) -> str:
        out = []
        for p in self.predicates.values():
            t = p.kind.value
            if p.is_list:
                t = f"[{t}]"
            d = ""
            if p.index_tokenizers:
                d += f" @index({', '.join(p.index_tokenizers)})"
            for flag, name in ((p.reverse, "reverse"), (p.count, "count"),
                               (p.lang, "lang"), (p.upsert, "upsert"),
                               (p.unique, "unique")):
                if flag:
                    d += f" @{name}"
            if p.vector_dim:
                d += f" @dim({p.vector_dim})"
            out.append(f"{p.name}: {t}{d} .")
        for t in self.types.values():
            fields = "\n".join(f"  {f}" for f in t.fields)
            out.append(f"type {t.name} {{\n{fields}\n}}")
        return "\n".join(out)


_PRED_RE = re.compile(
    r"^\s*<?([\w.][\w.\-/]*)>?\s*:\s*(\[?)\s*(\w+)\s*(\]?)\s*(.*?)\s*\.\s*$")
_TYPE_RE = re.compile(r"^\s*type\s+<?([\w.]+)>?\s*\{([^}]*)\}", re.S | re.M)
_DIRECTIVE_RE = re.compile(r"@(\w+)(?:\(([^)]*)\))?")


def parse_schema(text: str) -> Schema:
    """Parse schema-language text (reference: schema.ParseBytes)."""
    sch = Schema()
    # strip comments
    text = re.sub(r"#[^\n]*", "", text)
    # type blocks first (they span lines)
    for m in _TYPE_RE.finditer(text):
        name, body = m.group(1), m.group(2)
        fields = tuple(f.strip().strip("<>") for f in body.split() if f.strip())
        sch.types[name] = TypeDef(name=name, fields=fields)
    text = _TYPE_RE.sub("", text)

    for line in text.splitlines():
        if not line.strip():
            continue
        m = _PRED_RE.match(line)
        if not m:
            raise ValueError(f"bad schema line: {line!r}")
        name, lb, typ, rb, rest = m.groups()
        if bool(lb) != bool(rb):
            raise ValueError(f"unbalanced [] in schema line: {line!r}")
        try:
            kind = Kind(typ)
        except ValueError:
            raise ValueError(f"unknown type {typ!r} in schema line: {line!r}")
        if kind == Kind.VECTOR and lb:
            raise ValueError(
                f"float32vector predicates hold one vector per node — "
                f"list form is not supported: {line!r}")
        p = PredicateSchema(name=name, kind=kind, is_list=bool(lb))
        for dm in _DIRECTIVE_RE.finditer(rest):
            d, args = dm.group(1), dm.group(2)
            if d == "index":
                toks = tuple(t.strip() for t in (args or "").split(",") if t.strip())
                if not toks:
                    raise ValueError(f"@index needs tokenizers: {line!r}")
                for t in toks:
                    if t not in TOKENIZERS:
                        raise ValueError(f"unknown tokenizer {t!r}: {line!r}")
                if kind == Kind.UID:
                    raise ValueError(f"@index not allowed on uid predicate: {line!r}")
                p.index_tokenizers = toks
            elif d == "reverse":
                if kind != Kind.UID:
                    raise ValueError(f"@reverse only on uid predicates: {line!r}")
                p.reverse = True
            elif d == "count":
                p.count = True
            elif d == "lang":
                p.lang = True
            elif d == "upsert":
                p.upsert = True
            elif d == "unique":
                p.unique = True
            elif d == "dim":
                if kind != Kind.VECTOR:
                    raise ValueError(
                        f"@dim only on float32vector predicates: {line!r}")
                try:
                    p.vector_dim = int((args or "").strip())
                except ValueError:
                    raise ValueError(f"@dim needs an integer: {line!r}")
                if p.vector_dim <= 0:
                    raise ValueError(f"@dim must be positive: {line!r}")
            elif d == "noconflict":
                pass  # accepted, no-op (as in reference semantics for reads)
            else:
                raise ValueError(f"unknown directive @{d}: {line!r}")
        sch.predicates[name] = p
    return sch
