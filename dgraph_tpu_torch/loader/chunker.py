"""Mutation input parsing: RDF N-Quads and JSON → NQuad batches.

Port of `dgraph_tpu/loader/chunker.py`, unchanged.

Reference parity: `chunker/` (`ParseRDF` n-quad lexing into `api.NQuad`,
`ParseJSON` nested-object flattening with blank-node generation). The
subset covers what the reference's live/bulk loaders and mutation API
accept day-to-day: uid/blank subjects, string objects with language tags
and `^^` type hints, star deletion, RDF facet parens, and JSON facets via
the "pred|facet" key convention (index maps for lists).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass

_TYPE_MAP = {
    "xs:int": int, "xs:integer": int,
    "xs:float": float, "xs:double": float,
    "xs:boolean": lambda s: s.lower() == "true",
    "xs:string": str, "xs:dateTime": str,
}
for _k in list(_TYPE_MAP):
    _TYPE_MAP[f"http://www.w3.org/2001/XMLSchema#{_k.split(':')[1]}"] = _TYPE_MAP[_k]
# vector literal rides as its string form `"[0.1, ...]"`; the schema
# layer (types.parse_vector) decodes it at ingestion
_TYPE_MAP["float32vector"] = str


@dataclass
class NQuad:
    """One parsed statement (reference: api.NQuad)."""

    subject: str                 # "0x1" | "_:blank" | "uid(v)"
    predicate: str
    object_id: str | None = None   # uid-valued object
    object_value: object = None    # scalar-valued object
    lang: str = ""
    is_star: bool = False          # object "*" (delete-all)
    facets: dict | None = None     # (key=value, ...) edge metadata


_NQUAD_RE = re.compile(
    r'^\s*'
    r'(?:<([^>]*)>|(_:[A-Za-z0-9._-]+)|(uid\([^)]*\)))\s+'      # subject
    r'<([^>]*)>\s+'                                             # predicate
    r'(?:'
    r'<([^>]*)>|(_:[A-Za-z0-9._-]+)|(uid\([^)]*\))|(\*)|'       # object id/*
    r'"((?:[^"\\]|\\.)*)"'                                      # literal
    r'(?:@([A-Za-z-]+)|\^\^<([^>]*)>)?'
    r')'
    r'(?:\s*\(([^)]*)\))?'                                      # facets
    r'\s*\.\s*$')


def _parse_facets(spec: str) -> dict:
    """'since=2006-01-02, close=true, score=4' → typed facet dict
    (reference: facets in RDF mutations, chunker/rdf facet parsing)."""
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"facet needs key=value, got {part!r}")
        k, v = part.split("=", 1)
        k, v = k.strip(), v.strip()
        if v.startswith('"') and v.endswith('"'):
            out[k] = v[1:-1]
        elif v in ("true", "false"):
            out[k] = v == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def parse_rdf(text: str) -> list[NQuad]:
    """Parse N-Quad lines (reference: chunker/rdf parsing)."""
    out: list[NQuad] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        m = _NQUAD_RE.match(s)
        if not m:
            raise ValueError(f"bad N-Quad at line {lineno}: {line!r}")
        (s_iri, s_blank, s_var, pred, o_iri, o_blank, o_var, star,
         lit, lang, typ, facet_spec) = m.groups()
        subject = s_iri or s_blank or s_var
        nq = NQuad(subject=subject, predicate=pred)
        if facet_spec is not None:
            nq.facets = _parse_facets(facet_spec)
        if star:
            nq.is_star = True
        elif lit is not None:
            v: object = re.sub(r'\\(.)', r'\1', lit)
            if typ:
                conv = _TYPE_MAP.get(typ)
                if conv is None:
                    raise ValueError(f"unknown datatype {typ!r} line {lineno}")
                v = conv(v)
            nq.object_value = v
            nq.lang = lang or ""
        else:
            nq.object_id = o_iri or o_blank or o_var
        out.append(nq)
    return out


def parse_json(obj, _counter: list | None = None) -> list[NQuad]:
    """Flatten a JSON mutation object (reference: chunker/json.go).

    Nested objects without "uid" become blank nodes; lists fan out; keys
    "uid" and "dgraph.type" follow reference semantics.
    """
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    else:
        import copy
        obj = copy.deepcopy(obj)  # blank-node refs are injected into the
        # tree during flattening; never mutate the caller's object
    counter = _counter if _counter is not None else [0]
    out: list[NQuad] = []
    items = obj if isinstance(obj, list) else [obj]
    for it in items:
        _flatten(it, counter, out)
    return out


def _node_ref(it: dict, counter: list) -> str:
    uid = it.get("uid")
    if uid is None:
        counter[0] += 1
        uid = f"_:json.{counter[0]}"
        it["uid"] = uid
    return str(uid)


def _pop_facets(it: dict) -> dict[str, dict]:
    """Extract "pred|facet" keys (reference: chunker/json.go facet
    convention) → {pred: {facet: value}}. Scalar facets sit beside the
    value key in the SAME object; edge facets sit inside the CHILD
    object, keyed by the edge predicate."""
    fac: dict[str, dict] = {}
    for k in [k for k in it if "|" in k]:
        pred, _, fkey = k.partition("|")
        if pred and fkey:
            fac.setdefault(pred, {})[fkey] = it.pop(k)
    return fac


def _facets_at(fac_entry: dict | None, idx: int) -> dict | None:
    """Resolve a parent-level facet entry for list element `idx`:
    {"0": v, "1": w} index maps pick per element (reference:
    chunker/json.go list-facet convention); plain values apply to every
    element."""
    if not fac_entry:
        return None
    out = {}
    for fkey, v in fac_entry.items():
        if (isinstance(v, dict) and v
                and all(isinstance(x, str) and x.isdigit() for x in v)):
            if str(idx) in v:
                out[fkey] = v[str(idx)]
        else:
            out[fkey] = v
    return out or None


def _flatten(it: dict, counter: list, out: list[NQuad]) -> None:
    subj = _node_ref(it, counter)
    fac = _pop_facets(it)
    for k, v in list(it.items()):
        if k == "uid":
            continue
        vals = v if isinstance(v, list) else [v]
        for idx, one in enumerate(vals):
            if isinstance(one, dict):
                ref = _node_ref(one, counter)
                # edge facets: parent-level "k|facet" (index-mapped for
                # lists) merged with keys inside the child object under
                # the edge predicate's name — child-internal wins; the
                # child's OWN scalar facets stay for its _flatten pass
                edge_fac = _facets_at(fac.get(k), idx) or {}
                for fk in [fk for fk in one
                           if fk.startswith(k + "|")]:
                    edge_fac[fk.partition("|")[2]] = one.pop(fk)
                out.append(NQuad(subject=subj, predicate=k,
                                 object_id=ref,
                                 facets=edge_fac or None))
                _flatten(one, counter, out)
            elif one is None:
                out.append(NQuad(subject=subj, predicate=k, is_star=True))
            else:
                out.append(NQuad(subject=subj, predicate=k,
                                 object_value=one,
                                 facets=_facets_at(fac.get(k), idx)))
