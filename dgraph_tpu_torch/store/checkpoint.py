"""Checkpoint: versioned on-disk Store snapshots.

Port of `dgraph_tpu/store/checkpoint.py`: the manifest v3 format with
per-file crc32, the same file names and bytes, so a checkpoint written
by either package loads in the other. The uid block goes through the
port's `native.codec_encode` (`native/codec.cpp`).

Reference parity: the reference's three persistence mechanisms (SURVEY §5)
— Badger's LSM as durable posting storage, raft snapshots, and
export/binary-backup — collapse here into one: the host-disk CSR block
store with a versioned manifest. TPU HBM is a cache over this, never the
source of truth; recovery = reload (the stateless-sidecar failure model).

Layout:  <dir>/manifest.json
         <dir>/uids.npy
         <dir>/<pred-hash>.<fwd|rev>.indptr.npy / .indices.npy
         <dir>/<pred-hash>.val.<lang>.subj.npy / .vals.npy
Index blocks are rebuilt on load (cheap, and keeps the format stable
against tokenizer changes — the reference likewise rebuilds indexes on
schema migration rather than shipping them in backups).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from dgraph_tpu_torch.store import vault
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.types import Kind
from dgraph_tpu_torch.store.store import (
    EdgeRel, FacetCol, PredicateData, Store, ValueColumn, build_indexes)
# facet scalars use the WAL's codec so both durability paths (checkpoint
# vs WAL replay) recover identical types
from dgraph_tpu_torch.store.wal import dec_scalar, enc_scalar

FORMAT_VERSION = 3  # v3: per-file crc32 digests (WAL-style integrity)
MIN_FORMAT_VERSION = 1  # v1/v2 checkpoints load (no digests recorded —
#                         integrity checks are skipped for them)


def _slug(pred: str) -> str:
    h = hashlib.sha1(pred.encode()).hexdigest()[:12]
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in pred)
    return f"{safe[:40]}.{h}"


def save_uids(uids: np.ndarray, dirname: str, compress: bool) -> int:
    """Write the uid vocabulary block (`compress` delta-varint packs it
    via native/codec.cpp — the role the reference's codec.UidPack plays
    for posting storage). Returns the block's on-disk crc32 (recorded
    as `uids_crc` in the manifest and verified on every load)."""
    if compress:
        from dgraph_tpu_torch import native
        return vault.write_bytes(os.path.join(dirname, "uids.duc"),
                                 native.codec_encode(uids))
    return vault.save_np(os.path.join(dirname, "uids.npy"), uids)


def save_predicate(dirname: str, pred: str, pd) -> dict:
    """Write ONE predicate's tablet segment files; returns its manifest
    meta entry. The loop body of save() and the unit the streaming
    writer (store/stream.py) emits one-at-a-time, so checkpoint/backup/
    export of an out-of-core store never holds more than one tablet
    resident. Byte-identical segments either way."""
    slug = _slug(pred)
    nbytes = sum(r.indptr.nbytes + r.indices.nbytes
                 for r in (pd.fwd, pd.rev) if r is not None)
    nbytes += sum(c.subj.nbytes
                  + (c.vals.nbytes if c.vals.dtype != object
                     else len(c.vals) * 64)
                  for c in pd.vals.values())
    # nbytes: size hint for out-of-core eviction accounting and the
    # tablet-size heartbeat (neither may fault the tablet in)
    meta = {"slug": slug, "langs": sorted(pd.vals), "nbytes": nbytes}
    # per-file crc32 of the on-disk bytes: the tablet's integrity
    # digests, verified on every fault/load/restore of this segment set
    crcs: dict[str, int] = {}
    for side, rel in (("fwd", pd.fwd), ("rev", pd.rev)):
        if rel is not None:
            for part, arr in (("indptr", rel.indptr),
                              ("indices", rel.indices)):
                fname = f"{slug}.{side}.{part}.npy"
                crcs[fname] = vault.save_np(
                    os.path.join(dirname, fname), arr)
            meta[side] = True
    for lang, col in pd.vals.items():
        lslug = lang or "_"
        fname = f"{slug}.val.{lslug}.subj.npy"
        crcs[fname] = vault.save_np(os.path.join(dirname, fname),
                                    col.subj)
        vals = col.vals
        if pd.schema.kind == Kind.VECTOR:
            # vector columns persist as a dense [k, d] f32 stack — the
            # exact bytes the tablet serves, crc-verified like any
            # other segment (the GEO-string precedent, but binary)
            vals = (np.stack([np.asarray(v, np.float32) for v in vals])
                    if len(vals) else np.zeros((0, 0), np.float32))
        elif vals.dtype == object:  # strings: store as fixed-width UTF
            vals = np.array([str(v) for v in vals], dtype=np.str_)
        fname = f"{slug}.val.{lslug}.vals.npy"
        crcs[fname] = vault.save_np(os.path.join(dirname, fname), vals)
    if pd.efacets or pd.vfacets:
        # facets ride in a JSON sidecar (they are sparse; the reference
        # persists them inside each posting — same durability contract)
        fdoc = {
            "efacets": {k: {"pos": col.pos.tolist(),
                            "vals": [enc_scalar(v) for v in col.vals]}
                        for k, col in pd.efacets.items()},
            "vfacets": {k: {str(r): enc_scalar(v)
                            for r, v in m.items()}
                        for k, m in pd.vfacets.items()},
        }
        fname = f"{slug}.facets.json"
        crcs[fname] = vault.write_bytes(os.path.join(dirname, fname),
                                        json.dumps(fdoc).encode())
        meta["facets"] = True
    meta["crc"] = crcs
    return meta


def write_manifest(dirname: str, manifest: dict) -> None:
    """Atomically land the manifest — the commit point of a snapshot.
    The manifest is encrypted too: it carries the schema text and
    predicate names (the reference likewise keeps schema inside the
    encrypted store, exposing only sizes/timestamps in plaintext).
    vault.write_bytes is tmp+fsync+os.replace, so a kill mid-write
    leaves the previous manifest (or none) — never a torn one."""
    vault.write_bytes(os.path.join(dirname, "manifest.json"),
                      json.dumps(manifest, indent=1).encode())


def manifest_doc(n_nodes: int, schema_text: str, preds_meta: dict,
                 base_ts: int, compress: bool,
                 uids_crc: int | None = None) -> dict:
    doc = {
        "format_version": FORMAT_VERSION,
        "base_ts": base_ts,
        "n_nodes": n_nodes,
        "uids_codec": bool(compress),
        "schema": schema_text,
        "predicates": preds_meta,
    }
    if uids_crc is not None:
        doc["uids_crc"] = uids_crc
    return doc


def save(store: Store, dirname: str, base_ts: int = 0,
         compress: bool | None = None) -> None:
    """Write a Store snapshot (reference: export/backup at a timestamp).

    Materialization note: iterating `store.preds.items()` on an
    out-of-core store faults EVERY tablet in — use
    store/stream.py::save_streaming there (same format, same bytes,
    one tablet resident at a time)."""
    from dgraph_tpu_torch import native
    if compress is None:
        compress = native.HAVE_NATIVE
    os.makedirs(dirname, exist_ok=True)
    uids_crc = save_uids(store.uids, dirname, compress)
    preds_meta = {}
    for pred, pd in store.preds.items():
        preds_meta[pred] = save_predicate(dirname, pred, pd)
    write_manifest(dirname, manifest_doc(
        store.n_nodes, store.schema.to_text(), preds_meta, base_ts,
        compress, uids_crc=uids_crc))


def resolve(dirname: str) -> str:
    """Follow a CURRENT pointer (versioned-checkpoint layout written by
    save_versioned) if present; plain snapshot dirs resolve to themselves."""
    cur = os.path.join(dirname, "CURRENT")
    if os.path.exists(cur):
        with open(cur) as f:
            return os.path.join(dirname, f.read().strip())
    return dirname


def exists(dirname: str) -> bool:
    return os.path.exists(os.path.join(resolve(dirname), "manifest.json"))


def begin_versioned(dirname: str, base_ts: int) -> str | None:
    """First half of a crash-safe versioned checkpoint: pick the
    `ckpt-<ts>` subdir name, or None when CURRENT already names a
    fully-written ckpt-<base_ts> — re-saving would scribble over the
    live snapshot in place and a crash mid-save would leave NO intact
    snapshot. The MVCC contract makes base_ts identify the content, so
    the existing snapshot is exactly what we'd write — no-op."""
    os.makedirs(dirname, exist_ok=True)
    sub = f"ckpt-{base_ts:016d}"
    cur = os.path.join(dirname, "CURRENT")
    if os.path.exists(cur):
        with open(cur) as f:
            if (f.read().strip() == sub and os.path.exists(
                    os.path.join(dirname, sub, "manifest.json"))):
                return None
    return sub


def commit_versioned(dirname: str, sub: str, keep=()) -> None:
    """Second half: flip the CURRENT pointer atomically, then delete
    superseded subdirs. `keep` names subdirs that must SURVIVE the
    sweep — an out-of-core MVCC store's older fold points still fault
    tablets from their own ckpt dirs until gc drops them."""
    tmp = os.path.join(dirname, "CURRENT.tmp")
    with open(tmp, "w") as f:
        f.write(sub)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirname, "CURRENT"))
    for name in os.listdir(dirname):
        if name.startswith("ckpt-") and name != sub and name not in keep:
            import shutil
            shutil.rmtree(os.path.join(dirname, name), ignore_errors=True)


def save_versioned(store: Store, dirname: str, base_ts: int = 0) -> None:
    """Crash-safe checkpoint: write a fresh `ckpt-<ts>` subdir, then flip
    the CURRENT pointer atomically, then delete superseded subdirs. A kill
    at ANY point leaves either the old or the new snapshot fully intact —
    never a half-written mix (the durability role of Badger's MANIFEST)."""
    sub = begin_versioned(dirname, base_ts)
    if sub is None:
        return
    save(store, os.path.join(dirname, sub), base_ts=base_ts)
    commit_versioned(dirname, sub)


def read_manifest(dirname: str) -> tuple[dict, str]:
    """(manifest, resolved dir) with the format gate applied. A
    manifest that won't decode (bit-flip, truncation, tamper) raises a
    typed StorageCorruption naming the file."""
    dirname = resolve(dirname)
    mp = os.path.join(dirname, "manifest.json")
    try:
        manifest = json.loads(vault.read_bytes(mp))
    except (ValueError, vault.VaultError) as e:
        raise vault.corruption(mp, kind="manifest", detail=str(e)) from e
    if not isinstance(manifest, dict) or "format_version" not in manifest:
        raise vault.corruption(mp, kind="manifest",
                               detail="not a manifest document")
    if not (MIN_FORMAT_VERSION <= manifest["format_version"]
            <= FORMAT_VERSION):
        raise ValueError(
            f"checkpoint format {manifest['format_version']} not in "
            f"[{MIN_FORMAT_VERSION}, {FORMAT_VERSION}]")
    return manifest, dirname


def load_uids(dirname: str, manifest: dict) -> np.ndarray:
    crc = manifest.get("uids_crc")
    if manifest.get("uids_codec"):
        from dgraph_tpu_torch import native
        raw = vault.read_bytes(os.path.join(dirname, "uids.duc"),
                               crc=crc, kind="uids")
        try:
            return native.codec_decode(raw, manifest["n_nodes"])
        except Exception as e:  # undecodable varint stream
            raise vault.corruption(os.path.join(dirname, "uids.duc"),
                                   kind="uids", detail=str(e)) from e
    return vault.load_np(os.path.join(dirname, "uids.npy"),
                         crc=crc, kind="uids")


def load_predicate(dirname: str, pred: str, meta: dict,
                   schema) -> PredicateData:
    """Load ONE predicate's tablet from a snapshot dir — the unit the
    out-of-core store faults in on first touch (store/outofcore.py) and
    the loop body of a full load()."""
    slug = meta["slug"]
    crcs = meta.get("crc", {})  # absent on pre-v3 snapshots

    def _load(fname):
        return vault.load_np(os.path.join(dirname, fname),
                             crc=crcs.get(fname), kind="segment")

    pd = PredicateData(schema=schema.get(pred))
    for side in ("fwd", "rev"):
        if meta.get(side):
            indptr = _load(f"{slug}.{side}.indptr.npy")
            indices = _load(f"{slug}.{side}.indices.npy")
            setattr(pd, side, EdgeRel(indptr=indptr, indices=indices))
    for lang in meta["langs"]:
        lslug = lang or "_"
        vals = _load(f"{slug}.val.{lslug}.vals.npy")
        if vals.dtype.kind == "U":  # restore string columns to object
            vals = vals.astype(object)
        ps = schema.get(pred)
        if ps is not None and ps.kind == Kind.GEO and len(vals):
            # geo columns persist as GeoJSON strings; re-wrap
            from dgraph_tpu_torch.store.geo import parse_geo
            out = np.empty(len(vals), dtype=object)
            out[:] = [parse_geo(v) for v in vals]
            vals = out
        elif ps is not None and ps.kind == Kind.VECTOR:
            # dense [k, d] f32 stack → object column of row views
            rows = np.asarray(vals, np.float32)
            vals = np.empty(len(rows), dtype=object)
            vals[:] = [rows[i] for i in range(len(rows))]
        pd.vals[lang] = ValueColumn(
            subj=_load(f"{slug}.val.{lslug}.subj.npy"),
            vals=vals)
    if meta.get("facets"):
        fname = f"{slug}.facets.json"
        try:
            fdoc = json.loads(vault.read_bytes(
                os.path.join(dirname, fname),
                crc=crcs.get(fname), kind="segment"))
        except ValueError as e:
            raise vault.corruption(os.path.join(dirname, fname),
                                   kind="segment", detail=str(e)) from e
        for k, col in fdoc.get("efacets", {}).items():
            vals = np.empty(len(col["vals"]), dtype=object)
            vals[:] = [dec_scalar(v) for v in col["vals"]]
            pd.efacets[k] = FacetCol(
                pos=np.array(col["pos"], np.int64), vals=vals)
        for k, m in fdoc.get("vfacets", {}).items():
            pd.vfacets[k] = {int(r): dec_scalar(v)
                             for r, v in m.items()}
    return pd


def verify_snapshot(dirname: str) -> list[dict]:
    """Offline integrity walk of one snapshot dir: every file with a
    recorded digest is re-read raw and crc-checked WITHOUT decoding
    arrays (cheap — one sequential read per file). Returns a list of
    {"file", "kind", "detail"} problems, empty when clean. A manifest
    that won't decode raises StorageCorruption (there is nothing to
    walk without it). Pre-v3 snapshots (no digests) verify vacuously —
    reported as a single `undigested` advisory entry."""
    manifest, dirname = read_manifest(dirname)
    problems: list[dict] = []

    def check(fname, crc, kind):
        path = os.path.join(dirname, fname)
        if not os.path.exists(path):
            problems.append({"file": path, "kind": kind,
                             "detail": "missing"})
        elif crc is not None and not vault.file_crc_ok(path, crc):
            problems.append({"file": path, "kind": kind,
                             "detail": "crc mismatch"})

    uids_crc = manifest.get("uids_crc")
    uids_file = ("uids.duc" if manifest.get("uids_codec")
                 else "uids.npy")
    check(uids_file, uids_crc, "uids")
    digested = uids_crc is not None
    for _pred, meta in manifest["predicates"].items():
        crcs = meta.get("crc")
        if crcs is None:
            continue
        digested = True
        for fname, crc in crcs.items():
            check(fname, crc, "segment")
    if not digested and manifest["predicates"]:
        problems.append({"file": os.path.join(dirname, "manifest.json"),
                         "kind": "undigested",
                         "detail": "pre-v3 snapshot carries no digests "
                                   "(advisory; re-checkpoint to add)"})
    return problems


def load(dirname: str) -> tuple[Store, int]:
    """Load (store, base_ts). Reference: restore / bulk-load handoff.
    Accepts both plain snapshot dirs and versioned (CURRENT) layouts."""
    manifest, dirname = read_manifest(dirname)
    uids = load_uids(dirname, manifest)
    schema = parse_schema(manifest["schema"])
    preds: dict[str, PredicateData] = {}
    for pred, meta in manifest["predicates"].items():
        preds[pred] = load_predicate(dirname, pred, meta, schema)
    build_indexes(preds)
    return Store(uids=uids, schema=schema, preds=preds), manifest["base_ts"]
