"""Tablet snapshot codec: a whole predicate's postings as one blob.

Port of `dgraph_tpu/cluster/tablet.py`: the same blob, so a tablet
packed by either package unpacks in the other into equal arrays.

Reference parity: Badger `Stream` snapshot shipping (worker/snapshot.go,
tablet moves in zero/tablet.go) — how a tablet's data crosses node
boundaries. Here a tablet is already a columnar bundle (CSR pair, value
columns, facet columns), so the wire format is just npz + a JSON sidecar
for object-typed columns; indexes are NOT shipped — the receiver rebuilds
them locally (cheap, and keeps tokenizer versions node-local, the same
call checkpoint.load makes).
"""

from __future__ import annotations

import io
import json

import numpy as np

from dgraph_tpu_torch.store.store import (
    EdgeRel, FacetCol, PredicateData, ValueColumn, build_indexes)
from dgraph_tpu_torch.store.wal import dec_scalar, enc_scalar


def pack_tablet(pd: PredicateData) -> bytes:
    """PredicateData → blob (schema rides separately: receiver has it)."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"langs": sorted(pd.vals), "efacets": sorted(pd.efacets),
                  "vfacets": {}}
    for side, rel in (("fwd", pd.fwd), ("rev", pd.rev)):
        if rel is not None:
            arrays[f"{side}_indptr"] = rel.indptr
            arrays[f"{side}_indices"] = rel.indices
    for i, lang in enumerate(meta["langs"]):
        col = pd.vals[lang]
        arrays[f"val{i}_subj"] = col.subj
        vals = col.vals
        if vals.dtype == object:
            meta[f"val{i}_obj"] = [enc_scalar(v) for v in vals]
        else:
            arrays[f"val{i}_vals"] = vals
    for i, key in enumerate(meta["efacets"]):
        fc = pd.efacets[key]
        arrays[f"ef{i}_pos"] = fc.pos
        meta[f"ef{i}_vals"] = [enc_scalar(v) for v in fc.vals]
    meta["vfacets"] = {k: {str(r): enc_scalar(v) for r, v in m.items()}
                       for k, m in pd.vfacets.items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    blob_meta = json.dumps(meta).encode()
    return (len(blob_meta).to_bytes(4, "little") + blob_meta
            + buf.getvalue())


def unpack_tablet(blob: bytes, pred: str, schema) -> PredicateData:
    """Blob → PredicateData with locally rebuilt indexes."""
    mlen = int.from_bytes(blob[:4], "little")
    meta = json.loads(blob[4:4 + mlen])
    arrays = np.load(io.BytesIO(blob[4 + mlen:]), allow_pickle=False)
    pd = PredicateData(schema=schema.get(pred))
    for side in ("fwd", "rev"):
        if f"{side}_indptr" in arrays:
            setattr(pd, side, EdgeRel(indptr=arrays[f"{side}_indptr"],
                                      indices=arrays[f"{side}_indices"]))
    for i, lang in enumerate(meta["langs"]):
        subj = arrays[f"val{i}_subj"]
        if f"val{i}_obj" in meta:
            vals = np.empty(len(meta[f"val{i}_obj"]), dtype=object)
            vals[:] = [dec_scalar(v) for v in meta[f"val{i}_obj"]]
        else:
            vals = arrays[f"val{i}_vals"]
        pd.vals[lang] = ValueColumn(subj=subj, vals=vals)
    for i, key in enumerate(meta["efacets"]):
        vals = np.empty(len(meta[f"ef{i}_vals"]), dtype=object)
        vals[:] = [dec_scalar(v) for v in meta[f"ef{i}_vals"]]
        pd.efacets[key] = FacetCol(pos=arrays[f"ef{i}_pos"], vals=vals)
    for k, m in meta["vfacets"].items():
        pd.vfacets[k] = {int(r): dec_scalar(v) for r, v in m.items()}
    build_indexes({pred: pd})
    return pd
