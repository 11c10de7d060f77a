"""Export: dump a Store snapshot as RDF N-Quads or JSON.

Port of `dgraph_tpu/server/export.py`: the same bytes for the same
store. Reference parity: `worker/export.go` — stream every tablet at a read
timestamp into RDF/JSON files an operator (or the live/bulk loader) can
re-ingest. Round-trips with `loader.chunker.parse_rdf`.

Both exporters iterate via store/stream.py::iter_tablets — sorted
predicate order, one tablet faulted at a time on an out-of-core store
and released before the next, so an export never holds more than
budget + one tablet resident. In-core stores take the same code path
(get() is just a dict lookup), which is what makes the out-of-core
output byte-identical to the in-core one.
"""

from __future__ import annotations

import json
import re

import numpy as np

from dgraph_tpu_torch.store.store import TYPE_PRED, Store
from dgraph_tpu_torch.store.stream import iter_tablets
from dgraph_tpu_torch.store.types import Kind


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


_XS = {Kind.INT: "xs:int", Kind.FLOAT: "xs:float", Kind.BOOL: "xs:boolean",
       Kind.DATETIME: "xs:dateTime"}


def export_rdf(store: Store, out, pace=None) -> int:
    """Write N-Quads to a text file object; returns statement count."""
    n = 0
    for pred, pd in iter_tablets(store, pace=pace, job="export"):
        if pd.fwd is not None and pd.fwd.nnz:
            deg = pd.fwd.indptr[1:] - pd.fwd.indptr[:-1]
            src = np.repeat(np.arange(store.n_nodes), deg)
            for s_r, o_r in zip(src.tolist(), pd.fwd.indices.tolist()):
                out.write(f"<0x{int(store.uids[s_r]):x}> <{pred}> "
                          f"<0x{int(store.uids[o_r]):x}> .\n")
                n += 1
        for lang, col in sorted(pd.vals.items()):
            kind = pd.schema.kind
            for s_r, v in zip(col.subj.tolist(), col.vals):
                subj = f"<0x{int(store.uids[s_r]):x}>"
                if kind in _XS:
                    if isinstance(v, np.datetime64):
                        lit = f'"{v}"^^<xs:dateTime>'
                    elif kind == Kind.BOOL:
                        lit = f'"{"true" if v else "false"}"^^<xs:boolean>'
                    else:
                        lit = f'"{v}"^^<{_XS[kind]}>'
                else:
                    lit = f'"{_esc(str(v))}"'
                    if lang:
                        lit += f"@{lang}"
                out.write(f"{subj} <{pred}> {lit} .\n")
                n += 1
    return n


def export_json(store: Store, out, pace=None) -> int:
    """Write one JSON object per node (uid, values, edge uid refs).

    The per-node output dicts are the deliverable (O(output) host
    memory); STORE residency stays tablet-bounded via iter_tablets."""
    nodes: dict[int, dict] = {}

    def node(rank: int) -> dict:
        return nodes.setdefault(rank, {"uid": f"0x{int(store.uids[rank]):x}"})

    for pred, pd in iter_tablets(store, pace=pace, job="export"):
        if pd.fwd is not None and pd.fwd.nnz:
            deg = pd.fwd.indptr[1:] - pd.fwd.indptr[:-1]
            src = np.repeat(np.arange(store.n_nodes), deg)
            for s_r, o_r in zip(src.tolist(), pd.fwd.indices.tolist()):
                node(s_r).setdefault(pred, []).append(
                    {"uid": f"0x{int(store.uids[o_r]):x}"})
        for lang, col in sorted(pd.vals.items()):
            key = pred + (f"@{lang}" if lang else "")
            for s_r, v in zip(col.subj.tolist(), col.vals):
                d = node(s_r)
                pv = v.item() if isinstance(v, np.generic) and \
                    not isinstance(v, np.datetime64) else str(v)
                if pd.schema.is_list and pred != TYPE_PRED:
                    d.setdefault(key, []).append(pv)
                elif pred == TYPE_PRED:
                    d.setdefault("dgraph.type", []).append(pv)
                else:
                    d[key] = pv
    items = [nodes[r] for r in sorted(nodes)]
    json.dump(items, out, default=str)
    return len(items)
