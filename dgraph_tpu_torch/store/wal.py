"""Write-ahead log for committed mutations.

Port of `dgraph_tpu/store/wal.py`, the same record format and codec, so a
log written by either package replays in the other. The write lock is a
plain `threading.Lock`.

Reference parity: the durability role Badger plays in the reference —
every committed txn is on disk before the commit call returns, so a crash
between checkpoints loses nothing (SURVEY §5 mechanisms 1-2: raft WAL +
Badger LSM). The TPU build keeps CSR snapshots as the queryable format
(checkpoint.py) and this log as the fsync'd tail between snapshots:
recovery = load newest checkpoint + replay records above its base_ts.

Record format (torn-write safe, append-only):
    MAGIC(4) | len(u32 LE) | crc32(u32 LE) | payload JSON(len)
Replay stops at the first corrupt/short record — exactly the crash tail a
partially-flushed append leaves — and reports how many bytes were dropped.

Values are JSON-native scalars; non-JSON types (datetimes arriving as
numpy scalars) round-trip via a {"__t": ..., "v": ...} tag.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Iterator

import numpy as np

from dgraph_tpu_torch.store import vault
from dgraph_tpu_torch.store.mvcc import Mutation

MAGIC = b"DGW1"   # legacy frames (pre ordinal binding) — read-only
MAGIC2 = b"DGW2"  # current frames: payload AAD-bound to the ordinal
_HEADER = struct.Struct("<II")  # len, crc32


def enc_scalar(v):
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    if isinstance(v, np.datetime64):
        return {"__t": "dt", "v": np.datetime_as_string(v)}
    from dgraph_tpu_torch.store.geo import GeoVal
    if isinstance(v, GeoVal):
        return {"__t": "geo", "v": v.gj}
    if v is None or isinstance(v, str):
        return v
    return {"__t": "s", "v": str(v)}


def dec_scalar(v):
    if isinstance(v, dict) and "__t" in v:
        if v["__t"] == "dt":
            return np.datetime64(v["v"])
        if v["__t"] == "geo":
            from dgraph_tpu_torch.store.geo import GeoVal
            return GeoVal(v["v"])
        return v["v"]
    return v


def _enc_facets(f):
    return {k: enc_scalar(v) for k, v in f.items()} if f else None


def _mut_doc(mut: Mutation) -> dict:
    doc = {
        "es": [[s, p, o, _enc_facets(f)]
               for s, p, o, *rest in mut.edge_sets
               for f in [rest[0] if rest else None]],
        "ed": [[s, p, o] for s, p, o in mut.edge_dels],
        "vs": [[s, p, enc_scalar(v), lang, _enc_facets(f)]
               for s, p, v, lang, *rest in mut.val_sets
               for f in [rest[0] if rest else None]],
        "vd": [[s, p, None, lang] for s, p, _v, lang in mut.val_dels],
    }
    if mut.touch_uids:
        doc["tu"] = [int(u) for u in mut.touch_uids]
    return doc


def _doc_mut(doc: dict) -> Mutation:
    return Mutation(
        edge_sets=[(s, p, o, f) for s, p, o, f in doc["es"]],
        edge_dels=[(s, p, o) for s, p, o in doc["ed"]],
        val_sets=[(s, p, dec_scalar(v), lang, f)
                  for s, p, v, lang, f in doc["vs"]],
        val_dels=[(s, p, None, lang) for s, p, _v, lang in doc["vd"]],
        touch_uids=list(doc.get("tu", [])),
    )


def mut_to_bytes(mut: Mutation) -> bytes:
    """Standalone Mutation codec (cluster broadcast payloads reuse the WAL
    JSON encoding)."""
    return json.dumps(_mut_doc(mut), separators=(",", ":")).encode()


def mut_from_bytes(b: bytes) -> Mutation:
    return _doc_mut(json.loads(b))


class Journal:
    """Generic fsync'd append-only JSON-record log (torn-tail safe). The
    WAL layers mutation semantics on top; Zero journals its state machine
    through it directly (reference: the group-0 raft WAL role)."""

    def __init__(self, path: str, sync: bool = True):
        self.path = path
        self.sync = sync
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # A torn tail from a previous crash must be cut BEFORE appending:
        # records written after corrupt bytes would be unreachable by
        # replay (it stops at the first bad record) — acked-but-invisible.
        self._seq = 0  # ordinal of the next record (encryption AAD)
        needs_reseal = False
        if os.path.exists(path):
            valid_end, self._seq, needs_reseal = _scan_state(path)
            if valid_end < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())
        self._wlock = threading.Lock()
        self._f = open(path, "ab")
        if needs_reseal:
            self._reseal_legacy()

    def _reseal_legacy(self) -> None:
        """Legacy frames (pre-ordinal DGW1, or plaintext written before
        the key was enabled) would otherwise validate at every position
        forever — an indefinite replay/reorder window. The frame magic
        makes detection free (_scan_state flags them during the normal
        open scan); when any are present the whole file rewrites as
        ordinal-sealed DGW2 frames, closing the migration path eagerly."""
        with open(self.path, "rb") as f:
            data = f.read()
        self.rewrite(json.loads(_dec_payload(p, seq, legacy))
                     for seq, (_off, p, legacy) in enumerate(_scan(data)))

    @staticmethod
    def _frame(doc: dict, seq: int) -> bytes:
        # with encryption-at-rest active, each record payload is
        # AES-GCM-sealed individually with its ORDINAL as associated
        # data — a sealed record cannot be reordered, duplicated, or
        # spliced in at another position without failing the tag. The
        # CRC covers the ciphertext so torn-tail truncation still works
        # without the key (store/vault.py).
        payload = vault.encrypt(
            json.dumps(doc, separators=(",", ":")).encode(),
            aad=_rec_aad(seq))
        return MAGIC2 + _HEADER.pack(len(payload),
                                     zlib.crc32(payload)) + payload

    def append(self, doc: dict) -> None:
        # concurrent appenders (apply broadcasts race local commits) must
        # not interleave record bytes
        with self._wlock:
            rec = self._frame(doc, self._seq)
            # disk-fault injection seam (vault.set_io_fault): the hook may corrupt/shorten the frame (detected by the
            # CRC on replay — exactly a torn tail) or raise ENOSPC
            # (the append fails BEFORE the in-memory apply, so the
            # commit refuses instead of acking an unlogged record)
            rec = vault.io_faulted(self.path, rec)
            self._f.write(rec)
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())
            self._seq += 1

    def rewrite(self, docs) -> None:
        """Atomically replace the log's contents (temp file + rename).
        Holds the write lock for the whole rewrite — a concurrent append
        must neither hit a closed file nor land on the replaced inode."""
        with self._wlock:
            tmp = self.path + ".tmp"
            seq = 0
            with open(tmp, "wb") as f:
                for doc in docs:
                    f.write(self._frame(doc, seq))
                    seq += 1
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
            self._seq = seq

    @staticmethod
    def replay(path: str):
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        for seq, (_off, payload, legacy) in enumerate(_scan(data)):
            yield json.loads(_dec_payload(payload, seq, legacy))

    def close(self) -> None:
        # under the write lock: a crash-stop (test harness _kill_node)
        # closes from another thread while appenders may be mid-frame —
        # closing out from under an in-flight write tears the tail the
        # CRC scan then has to cut
        with self._wlock:
            self._f.close()


class WAL(Journal):
    """Append-only fsync'd mutation log, one file per store directory."""

    def append(self, mut: Mutation, commit_ts: int) -> None:  # type: ignore[override]
        """Durably record a committed mutation. Called AFTER the oracle
        assigns commit_ts and BEFORE the in-memory apply — a crash between
        the two replays the record (apply is idempotent set-semantics)."""
        super().append({"ts": commit_ts, "m": _mut_doc(mut)})

    def append_schema(self, schema_text: str, ts: int) -> None:
        """Durably record an Alter's schema text (replay re-runs the
        rebuild; reference: schema mutations ride the same raft log)."""
        super().append({"ts": ts, "schema": schema_text})

    def append_drop(self, ts: int) -> None:
        """Durably record a DropAll (replay resets, not resurrects)."""
        super().append({"ts": ts, "drop": 1})

    def append_drop_attr(self, pred: str, ts: int) -> None:
        """Durably record a DropAttr (replay re-drops the predicate)."""
        super().append({"ts": ts, "drop_attr": pred})

    def append_pend(self, mut: Mutation, commit_ts: int) -> None:
        """Durably log a STAGED mutation (commit-quorum phase 1,
        reference: raft log append before commit). Not applied until a
        matching decision marker commits it; an unresolved pend is
        invisible to readers and was never acked to any client."""
        super().append({"ts": commit_ts, "pend": _mut_doc(mut)})

    def append_decision(self, commit_ts: int, commit: bool) -> None:
        """Durably record the coordinator's commit/abort decision for a
        staged ts (commit-quorum phase 2; the raft commit-index analog)."""
        super().append({"ts": commit_ts, "dec": 1 if commit else 0})

    def truncate(self, upto_ts: int) -> None:
        """Drop records with commit_ts ≤ upto_ts (checkpoint just absorbed
        them); the tail survives atomically. Unresolved pends survive
        regardless of ts — they were never applied, so no checkpoint
        absorbed them. Two STREAMING passes (decision index, then the
        rewrite): truncate runs inside checkpoint_to next to the rollup's
        materialization, so buffering every decoded record here would
        stack two whole-store memory spikes."""
        def doc_of(ts, kind, obj):
            if kind == "mut":
                return {"ts": ts, "m": _mut_doc(obj)}
            if kind == "pend":
                return {"ts": ts, "pend": _mut_doc(obj)}
            if kind == "dec":
                return {"ts": ts, "dec": obj}
            if kind == "drop":
                return {"ts": ts, "drop": 1}
            if kind == "drop_attr":
                return {"ts": ts, "drop_attr": obj}
            return {"ts": ts, "schema": obj}

        decided = {ts for ts, kind, _obj in replay(self.path)
                   if kind == "dec"}
        self.rewrite(
            doc_of(ts, kind, obj) for ts, kind, obj in replay(self.path)
            if ts > upto_ts or (kind == "pend" and ts not in decided))


def _scan(data: bytes) -> Iterator[tuple[int, bytes, bool]]:
    """Yield (record_end_offset, payload, is_legacy_frame) for every
    intact record. Legacy = a DGW1 frame (sealed before ordinal AAD
    binding); only those may use the no-AAD decrypt fallback."""
    off = 0
    hdr = len(MAGIC) + _HEADER.size
    while off + hdr <= len(data):
        magic = data[off:off + len(MAGIC)]
        if magic != MAGIC and magic != MAGIC2:
            return
        ln, crc = _HEADER.unpack(data[off + len(MAGIC):off + hdr])
        payload = data[off + hdr:off + hdr + ln]
        if len(payload) < ln or zlib.crc32(payload) != crc:
            return
        off += hdr + ln
        yield off, payload, magic == MAGIC


def _rec_aad(seq: int) -> bytes:
    return b"wal-rec:%d" % seq


def _dec_payload(payload: bytes, seq: int, legacy: bool = False) -> bytes:
    """Unseal a record at ordinal `seq`. ONLY legacy (DGW1) frames may
    fall back to the no-AAD seal — a DGW2 frame that fails its ordinal
    check is tampering, not migration (Journal.__init__ re-seals legacy
    files on open, so the fallback only runs for read-only replay of a
    not-yet-migrated file)."""
    if not legacy:
        return vault.decrypt(payload, aad=_rec_aad(seq))
    try:
        return vault.decrypt(payload, aad=_rec_aad(seq))
    except vault.VaultError:
        return vault.decrypt(payload)


def _scan_state(path: str) -> tuple[int, int, bool]:
    """(intact-prefix end offset, record count, needs_reseal): the last
    is True when encryption is active and any frame is legacy (DGW1) or
    still plaintext — detected from the frame headers alone, so a fully
    migrated log pays nothing extra on open."""
    with open(path, "rb") as f:
        data = f.read()
    end = n = 0
    mig = False
    enc = vault.active()
    for off, payload, legacy in _scan(data):
        end = off
        n += 1
        if enc and (legacy or not vault.is_encrypted(payload)):
            mig = True
    return end, n, mig


def _valid_end(path: str) -> int:
    """Byte offset where the intact record prefix ends."""
    return _scan_state(path)[0]


def replay(path: str) -> Iterator[tuple[int, str, object]]:
    """Yield (ts, kind, obj) in append order — kind "mut" with a Mutation,
    or "schema" with the merged schema text. Stops cleanly at a
    torn/corrupt tail (reference: raft WAL replay below HardState)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        data = f.read()
    for seq, (_off, payload, legacy) in enumerate(_scan(data)):
        doc = json.loads(_dec_payload(payload, seq, legacy))
        if "schema" in doc:
            yield int(doc["ts"]), "schema", doc["schema"]
        elif "drop" in doc:
            yield int(doc["ts"]), "drop", None
        elif "drop_attr" in doc:
            yield int(doc["ts"]), "drop_attr", doc["drop_attr"]
        elif "pend" in doc:
            yield int(doc["ts"]), "pend", _doc_mut(doc["pend"])
        elif "dec" in doc:
            yield int(doc["ts"]), "dec", int(doc["dec"])
        else:
            yield int(doc["ts"]), "mut", _doc_mut(doc["m"])


def resolved_replay(path: str) -> Iterator[tuple[int, str, object]]:
    """Replay with commit-quorum staging RESOLVED: a pend followed by its
    dec:1 yields kind "mut" at the decision point (the commit-index
    analog — ordering against schema/drop records is the decision's,
    not the stage's); dec:0 yields kind "abort" (peers drop their
    matching pending entry); an unresolved trailing pend is skipped —
    it was never applied or acked anywhere."""
    pend: dict[int, object] = {}
    for ts, kind, obj in replay(path):
        if kind == "pend":
            pend[ts] = obj
        elif kind == "dec":
            mut = pend.pop(ts, None)
            if obj and mut is not None:
                yield ts, "mut", mut
            elif not obj:
                yield ts, "abort", None
        else:
            yield ts, kind, obj
