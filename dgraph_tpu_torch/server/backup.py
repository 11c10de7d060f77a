"""Binary backup/restore: full + incremental-since-ts series.

Port of `dgraph_tpu/server/backup.py`: the same series layout, manifests,
delta logs and restore journal, so a chain written by either package
restores on the other, array for array. The restore folds each tablet
with the port's numpy fold (`store/mvcc.py:_materialize`). An offline
`backup` opens its Alpha on the CPU: it folds and writes files and runs
no query. Reference parity: `ee/backup` + `worker/backup*.go` (SURVEY §2.5) — the
enterprise binary backup: a SERIES of backups in one destination
directory, each either a full snapshot or an incremental carrying only
the commits since the previous backup's read timestamp, plus a restore
that folds the chain back into a serveable posting directory.

Layout under <dest>/:
    backup-<seq:04d>-<full|incr>/
        backup_manifest.json   {type, seq, since_ts, read_ts}
        (full)  the checkpoint snapshot files (store/checkpoint.py)
        (incr)  delta.log — WAL-format records in (since_ts, read_ts]

Incrementals read the source WAL, so they are only possible while the
WAL still covers the previous backup's read_ts (a checkpoint truncates
absorbed records); `backup()` falls back to a full backup automatically
when the chain can't be extended — same behavior as the reference when
the since-ts is below the oldest Badger version.

Durability/integrity contract:

* Every checkpoint-format file in a full backup carries a crc32 digest
  in its manifest (store/checkpoint.py v3); delta logs are WAL-framed
  (per-record CRC) and their manifests record the exact record count.
  `verify_chain` walks a whole series offline (`dgraph_tpu backup
  verify`, `POST /admin/backup/verify` in the reference's CLI and HTTP
  front end); any failed check during
  restore raises a typed, retryable `StorageCorruption` naming the
  file — corruption is never folded into a serveable store silently.
* `restore` is CRASH-SAFE, RESUMABLE, and STREAMING: the chain folds
  tablet-at-a-time (under `memory_budget` on stores larger than RAM)
  into a `ckpt-<ts>` staging subdir, journaling each completed tablet
  to an fsync'd WAL-format restore journal. A kill at ANY point leaves
  either the previous store or the completed one serveable — never
  neither — and a re-run resumes from the last verified tablet instead
  of starting over. CURRENT flips only after every digest re-verifies.
* `_series` skips (and the next successful backup removes) half-written
  backup dirs, so a killed backup never wedges the series.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil

from dgraph_tpu_torch.store import checkpoint, vault
from dgraph_tpu_torch.store.wal import Journal, _mut_doc, replay
from dgraph_tpu_torch.utils import tracing
from dgraph_tpu_torch.utils.metrics import METRICS

MANIFEST = "backup_manifest.json"
RESTORE_JOURNAL = "restore.journal"


def _read_backup_manifest(name: str, dirpath: str, strict: bool):
    """One backup dir's manifest, or None to skip it. Half-written dirs
    (no manifest, or the writer's .tmp still present) are skipped in
    every mode — the next successful backup removes them. A manifest
    that EXISTS but won't decode is skipped while appending (counted,
    logged — the writer must not wedge) but raises a typed
    StorageCorruption under `strict` (restore: a silently shortened
    chain would quietly restore old data)."""
    from dgraph_tpu_torch.utils import logging as xlog

    mp = os.path.join(dirpath, MANIFEST)
    if not os.path.exists(mp) or os.path.exists(mp + ".tmp"):
        return None
    try:
        with open(mp) as f:
            m = json.load(f)
        if not isinstance(m, dict) or "seq" not in m:
            raise ValueError("not a backup manifest")
    except ValueError as e:
        if strict:
            raise vault.corruption(mp, kind="manifest",
                                   detail=str(e)) from e
        METRICS.inc("sidecar_load_failures_total",
                    file="backup_manifest.json")
        xlog.get("backup").warning(
            "skipping backup dir %s: undecodable manifest (%s)",
            dirpath, e)
        return None
    m["dir"] = dirpath
    return m


def _series(dest: str, strict: bool = False) -> list[dict]:
    """Existing backups, ascending by seq. Half-written dirs are
    skipped (never crash the next backup); `strict` escalates an
    undecodable manifest to StorageCorruption (the restore path)."""
    out = []
    if not os.path.isdir(dest):
        return out
    for name in sorted(os.listdir(dest)):
        dirpath = os.path.join(dest, name)
        if not os.path.isdir(dirpath):
            continue
        m = _read_backup_manifest(name, dirpath, strict)
        if m is not None:
            out.append(m)
    return sorted(out, key=lambda m: m["seq"])


def _clean_partial(dest: str) -> int:
    """Remove half-written backup dirs (killed mid-backup: manifest
    missing or its .tmp still present) before appending — their seq
    slot is about to be reused. Never touches dirs with an intact
    manifest, even an undecodable one (that is operator evidence)."""
    n = 0
    if not os.path.isdir(dest):
        return 0
    for name in sorted(os.listdir(dest)):
        dirpath = os.path.join(dest, name)
        if not (os.path.isdir(dirpath) and name.startswith("backup-")):
            continue
        mp = os.path.join(dirpath, MANIFEST)
        if not os.path.exists(mp) or os.path.exists(mp + ".tmp"):
            shutil.rmtree(dirpath, ignore_errors=True)
            n += 1
    return n


def backup(p_dir: str, dest: str, force_full: bool = False,
           memory_budget: int | None = None) -> dict:
    """Append one backup to the series at `dest` from the posting dir
    `p_dir` (offline form: opens its own Alpha). `memory_budget` (bytes)
    opens the source OUT-OF-CORE so a store larger than RAM backs up
    tablet-at-a-time. Returns the new manifest."""
    from dgraph_tpu_torch.server.api import Alpha

    alpha = Alpha.open(p_dir, sync=False, memory_budget=memory_budget,
                       device="cpu")
    try:
        return backup_alpha(alpha, p_dir, dest, force_full=force_full)
    finally:
        if alpha.wal is not None:
            alpha.wal.close()


def backup_alpha(alpha, p_dir: str, dest: str,
                 force_full: bool = False, pace=None) -> dict:
    """Append one backup from a LIVE Alpha (the maintenance scheduler's
    backup job runs this while the node serves). Incrementals copy only
    WAL records — never materialize anything; full backups of an
    out-of-core store stream the fold tablet-at-a-time
    (store/stream.py), so resident bytes stay under budget + one
    tablet. The series manifest format is unchanged — existing
    restore() reads both in-core- and stream-written fulls."""
    from dgraph_tpu_torch.store import stream

    _clean_partial(dest)  # a killed predecessor's seq slot is reusable
    series = _series(dest)
    seq = (series[-1]["seq"] + 1) if series else 1
    last_ts = series[-1]["read_ts"] if series else 0

    # the oracle watermark covers EVERY replayed record — including a
    # trailing DropAll, which resets mvcc state to ts 0 and would
    # otherwise regress read_ts and fall out of the incremental window
    read_ts = max(alpha.mvcc.base_ts, alpha.oracle.max_assigned,
                  max((l.commit_ts for l in alpha.mvcc.layers), default=0))

    wal_path = (alpha.wal.path if alpha.wal is not None
                else os.path.join(p_dir, "wal.log"))
    wal_floor = alpha.mvcc.base_ts  # records ≤ this were absorbed
    incremental = (not force_full and series
                   and last_ts >= wal_floor)
    kind = "incr" if incremental else "full"
    bdir = os.path.join(dest, f"backup-{seq:04d}-{kind}")
    os.makedirs(bdir, exist_ok=True)

    if incremental:
        # WAL records in (last_ts, read_ts] — the delta since the chain tip
        seg = Journal(os.path.join(bdir, "delta.log"), sync=False)
        n = 0
        for ts, k, obj in replay(wal_path):
            if ts <= last_ts or ts > read_ts:
                continue
            if k == "mut":
                seg.append({"ts": ts, "m": _mut_doc(obj)})
            elif k == "schema":
                seg.append({"ts": ts, "schema": obj})
            elif k == "drop_attr":
                seg.append({"ts": ts, "drop_attr": obj})
            else:
                seg.append({"ts": ts, "drop": 1})
            n += 1
        seg.close()
        extra = {"records": n}
    elif stream.lazy_preds(alpha.mvcc.base) is not None:
        # out-of-core full: fold + write ONE TABLET AT A TIME straight
        # into the backup dir (no fold-point install — the backup is a
        # byproduct, not a new serving snapshot)
        _ts, _guard = stream.write_fold(alpha.mvcc, bdir, pace=pace,
                                        job="backup", manifest_ts=read_ts)
        manifest_n, _dir = checkpoint.read_manifest(bdir)
        extra = {"n_nodes": manifest_n["n_nodes"]}
        last_ts = 0
    else:
        store = alpha.mvcc.rollup()
        checkpoint.save(store, bdir, base_ts=read_ts)
        extra = {"n_nodes": store.n_nodes}
        last_ts = 0

    manifest = {"type": kind, "seq": seq,
                "since_ts": last_ts if incremental else 0,
                "read_ts": read_ts, **extra}
    # tmp + fsync + os.replace: the manifest IS the backup's commit
    # point — a kill mid-write must leave a recognizably-partial dir
    # (skipped + cleaned), never a torn manifest read as a real one
    tmp = os.path.join(bdir, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(bdir, MANIFEST))
    return manifest


# ---------------------------------------------------------------------------
# restore: crash-safe, resumable, streaming


def _chain_of(series: list[dict], dest: str):
    """(base full manifest, later incrementals) with the contiguity
    check applied — each incr's since_ts is the previous read_ts."""
    fulls = [m for m in series if m["type"] == "full"]
    if not fulls:
        raise FileNotFoundError(f"no full backup in {dest}")
    base_m = fulls[-1]
    chain = [m for m in series
             if m["seq"] > base_m["seq"] and m["type"] == "incr"]
    prev = base_m
    for m in chain:
        if m["since_ts"] != prev["read_ts"]:
            raise ValueError(
                f"backup chain broken: seq {m['seq']} covers "
                f"({m['since_ts']}, {m['read_ts']}] but previous read_ts "
                f"is {prev['read_ts']}")
        prev = m
    return base_m, chain


class _MaskedPreds:
    """Base-store predicate mapping with dropped tablets hidden: a
    predicate dropped mid-chain must not contribute its BASE content to
    the fold (post-drop rebirth records still apply as layers)."""

    def __init__(self, inner, hidden: set):
        self._inner = inner
        self._hidden = hidden

    def get(self, pred, default=None):
        if pred in self._hidden:
            return default
        return self._inner.get(pred, default)

    def __getitem__(self, pred):
        pd = self.get(pred)
        if pd is None:
            raise KeyError(pred)
        return pd

    def __contains__(self, pred):
        return pred not in self._hidden and pred in self._inner

    def keys(self):
        return [p for p in self._inner.keys() if p not in self._hidden]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.keys())

    def items(self):
        return [(p, self._inner[p]) for p in self.keys()]

    def values(self):
        return [self._inner[p] for p in self.keys()]


def _resume_state(jpath: str, fp: dict, staging: str):
    """Load the restore journal's resume state: {name: meta} for every
    tablet (and the uids block, key "__uids__") whose files RE-VERIFY
    against their journaled digests. A journal from a different chain/
    target discards itself and the staging dir — resume must never mix
    two restores."""
    done: dict[str, object] = {}
    if not os.path.exists(jpath):
        return done
    docs = list(Journal.replay(jpath))
    if not docs or docs[0].get("begin") != fp:
        os.remove(jpath)
        shutil.rmtree(staging, ignore_errors=True)
        return done
    for doc in docs[1:]:
        if "uids" in doc:
            done["__uids__"] = doc["uids"]
        elif "tablet" in doc:
            done[doc["tablet"]] = doc.get("meta")
    # drop entries whose on-disk bytes no longer match the journaled
    # digests (a torn write after the journal record is impossible —
    # segment writes are atomic and journaled AFTER — but a damaged
    # disk is exactly what we must not resume over)
    for name in list(done):
        meta = done[name]
        if name == "__uids__":
            ufile = next((os.path.join(staging, f)
                          for f in ("uids.duc", "uids.npy")
                          if os.path.exists(os.path.join(staging, f))),
                         None)
            if ufile is None or not vault.file_crc_ok(ufile, meta):
                del done[name]
        elif meta is not None:
            for fname, crc in meta.get("crc", {}).items():
                if not vault.file_crc_ok(os.path.join(staging, fname),
                                         crc):
                    del done[name]
                    break
    return done


def restore(dest: str, p_dir: str,
            memory_budget: int | None = None, pace=None) -> int:
    """Rebuild a serveable posting dir from the backup series: newest
    full + every later incremental, in order (reference: ee restore
    map/reduce over backup layers). Returns the restored max commit_ts.

    Crash-safe + resumable + streaming (module docstring): folds the
    chain ONE TABLET AT A TIME (out-of-core under `memory_budget`) into
    a versioned staging subdir with an fsync'd per-tablet journal; a
    kill at any point leaves the previous store serveable and a re-run
    resumes from the last verified tablet. Every digest re-verifies
    before the CURRENT flip."""
    from dgraph_tpu_torch.store.mvcc import MVCCStore
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.wal import _doc_mut

    series = _series(dest, strict=True)
    base_m, chain = _chain_of(series, dest)

    if memory_budget is not None:
        from dgraph_tpu_torch.store.outofcore import open_out_of_core
        store, base_ts = open_out_of_core(base_m["dir"], memory_budget)
    else:
        store, base_ts = checkpoint.load(base_m["dir"])
    mvcc = MVCCStore(base=store, base_ts=base_ts)
    max_ts = base_ts
    schema = None                 # merged Alter text, applied at fold
    dropped: dict[str, int] = {}  # pred → newest drop_attr ts
    for m in chain:
        dpath = os.path.join(m["dir"], "delta.log")
        n = 0
        try:
            for doc in Journal.replay(dpath):
                ts = int(doc["ts"])
                n += 1
                if "schema" in doc:
                    merged = (schema or mvcc.schema).clone()
                    merged.update(parse_schema(doc["schema"]))
                    schema = merged
                elif "drop" in doc:
                    mvcc = MVCCStore()
                    schema = None   # post-drop alters start from scratch
                    dropped = {}
                elif "drop_attr" in doc:
                    pred = doc["drop_attr"]
                    dropped[pred] = ts
                    # a later schema record must not resurrect it
                    merged = (schema or mvcc.schema).clone()
                    merged.predicates.pop(pred, None)
                    schema = merged
                else:
                    mvcc.apply(_doc_mut(doc["m"]), ts)
                max_ts = max(max_ts, ts)
        except vault.VaultError as e:
            raise vault.corruption(dpath, kind="delta",
                                   detail=str(e)) from e
        want = m.get("records")
        if want is not None and n != int(want):
            # WAL framing CRCs every record: a bit-flip or truncation
            # silently ends the replay early — the manifest's count
            # turns that into a typed refusal naming the file
            raise vault.corruption(
                dpath, kind="delta",
                detail=f"replayed {n} of {want} records "
                       f"(torn or corrupt)")
    return _restore_fold(
        mvcc, schema, dropped, p_dir, max_ts, pace=pace,
        chain_fp={"base_seq": int(base_m["seq"]),
                  "base_ts": int(base_m["read_ts"]),
                  "links": len(chain), "max_ts": int(max_ts)})


def _sweep_plain(p_dir: str) -> None:
    """Retire a superseded PLAIN-layout snapshot after the CURRENT flip
    (best-effort: resolve() already prefers CURRENT; these files are
    unreferenced bytes)."""
    for f in os.listdir(p_dir):
        if f == "manifest.json" or f.endswith(".npy") \
                or f.endswith(".facets.json") or f in ("uids.duc",):
            with contextlib.suppress(OSError):
                os.remove(os.path.join(p_dir, f))


def _restore_fold(mvcc, schema, dropped, p_dir: str, max_ts: int,
                  chain_fp: dict, pace=None) -> int:
    """Fold the replayed chain into `p_dir`, tablet-at-a-time, under a
    versioned staging subdir + fsync'd restore journal (see restore)."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.store import stream
    from dgraph_tpu_torch.store.mvcc import (_Layer, _materialize, fold_preds,
                                       fold_vocab)
    from dgraph_tpu_torch.store.store import Store

    os.makedirs(p_dir, exist_ok=True)
    jpath = os.path.join(p_dir, RESTORE_JOURNAL)
    sub = checkpoint.begin_versioned(p_dir, max_ts)
    if sub is None:
        # CURRENT already names this exact restore (a re-run after the
        # flip): finish the cleanup the kill skipped and report done
        with contextlib.suppress(OSError):
            os.remove(jpath)
        _sweep_plain(p_dir)
        return max_ts
    staging = os.path.join(p_dir, sub)

    plan = mvcc.fold_plan()
    _fold_ts, base, pending, _new_ts, _guard = plan
    # drop-aware effective layers: records at or below a predicate's
    # drop point are excluded (Mutation.exclude keeps the vocab touch
    # set, so the fold vocabulary is unchanged); the predicate's BASE
    # content is masked out entirely — only post-drop rebirths survive
    eff = []
    for l in pending:
        gone = {p for p, cut in dropped.items() if l.commit_ts <= cut}
        eff.append(_Layer(l.commit_ts, l.mut.exclude(gone))
                   if gone else l)
    base_eff = base
    if dropped:
        base_eff = Store(uids=base.uids, schema=base.schema,
                         preds=_MaskedPreds(base.preds, set(dropped)))
    schema_final = (schema if schema is not None else base.schema).clone()
    for pred in dropped:
        if not any(rec[1] == pred
                   for l in eff
                   for rec in (l.mut.edge_sets + l.mut.edge_dels
                               + l.mut.val_sets)):
            schema_final.predicates.pop(pred, None)
    # no pending records, drops, or alters: stream base tablets through
    # verbatim (skipping the builder round-trip keeps segments
    # byte-identical to the backup's own — the stream.write_fold rule)
    trivial = not eff and not dropped and schema is None
    vocab = base.uids if trivial else fold_vocab(base_eff, eff)
    names = fold_preds(base_eff, eff)
    alive = []
    for pred in names:
        if pred in dropped and not any(
                rec[1] == pred for l in eff
                for rec in (l.mut.edge_sets + l.mut.edge_dels
                            + l.mut.val_sets + l.mut.val_dels)):
            continue  # dropped, never reborn
        alive.append(pred)

    fp = {"sub": sub, "chain": chain_fp}
    done = _resume_state(jpath, fp, staging)
    journal = Journal(jpath, sync=True)
    if not done:
        journal.rewrite([{"begin": fp}])
    else:
        METRICS.inc("restore_resumed_total")

    compress = native.HAVE_NATIVE
    if "__uids__" in done:
        # a resumed restore keeps the codec its first run staged: the
        # journaled uids digest is that file's, and the manifest must
        # name the codec of the block it sits beside
        compress = os.path.exists(os.path.join(staging, "uids.duc"))
    lazy = stream.lazy_preds(base)
    written = resumed = 0
    try:
        with tracing.span("maintenance.job", job="restore") as sp:
            os.makedirs(staging, exist_ok=True)
            uids_crc = done.get("__uids__")
            if uids_crc is None:
                uids_crc = checkpoint.save_uids(vocab, staging, compress)
                journal.append({"uids": uids_crc})
            preds_meta = {}
            for pred in alive:
                if pred in done:
                    meta = done[pred]
                    if meta is not None:
                        preds_meta[pred] = meta
                    resumed += 1
                    METRICS.inc("restore_tablets_total",
                                outcome="resumed")
                    continue
                was_resident = (lazy.is_resident(pred)
                                if lazy is not None else True)
                with tracing.span("maintenance.tablet", pred=pred,
                                  job="restore"):
                    if trivial:
                        pd = base.preds.get(pred)
                    else:
                        folded = _materialize(base_eff, eff,
                                              schema=schema_final,
                                              only={pred}, vocab=vocab)
                        pd = folded.preds.get(pred)
                    meta = (checkpoint.save_predicate(staging, pred, pd)
                            if pd is not None else None)
                    if meta is not None:
                        preds_meta[pred] = meta
                    # the journal record lands AFTER the tablet's atomic
                    # segment writes: a kill between them re-writes the
                    # tablet, never trusts a half-written one
                    journal.append({"tablet": pred, "meta": meta})
                del pd
                if lazy is not None and not was_resident:
                    lazy.release(pred)
                written += 1
                METRICS.inc("restore_tablets_total", outcome="written")
                if pace is not None:
                    pace()
            checkpoint.write_manifest(staging, checkpoint.manifest_doc(
                int(len(vocab)), schema_final.to_text(), preds_meta,
                max_ts, compress, uids_crc=uids_crc))
            # EVERY digest re-verifies before the flip — a restore must
            # never install a store it cannot prove intact
            problems = [p for p in checkpoint.verify_snapshot(staging)
                        if p["kind"] != "undigested"]
            if problems:
                raise vault.corruption(
                    problems[0]["file"], kind=problems[0]["kind"],
                    detail=f"restore re-verify failed "
                           f"({len(problems)} file(s))")
            # fresh empty WAL BEFORE the flip: everything restored lives
            # in the checkpoint. (Flipping first would let a crash
            # replay the REPLACED store's WAL tail onto the restored
            # snapshot; this order's worst case is the doomed old store
            # minus its tail — still serveable.)
            vault.atomic_write(os.path.join(p_dir, "wal.log"), b"")
            checkpoint.commit_versioned(p_dir, sub)
            sp.attrs["tablets_total"] = len(alive)
            sp.attrs["tablets_written"] = written
            sp.attrs["tablets_resumed"] = resumed
    finally:
        journal.close()
    _sweep_plain(p_dir)
    with contextlib.suppress(OSError):
        os.remove(jpath)
    return max_ts


# ---------------------------------------------------------------------------
# offline chain verification (`dgraph_tpu backup verify`,
# POST /admin/backup/verify)


def verify_chain(dest: str) -> dict:
    """Walk a backup series offline: manifest decode, per-file digests
    of every full (store/checkpoint.py v3), per-record CRC + exact
    record count of every delta log, and chain contiguity. Returns
    {"ok", "backups", "errors", "warnings"} — `errors` name the exact
    files; `warnings` cover advisory states (half-written dirs awaiting
    cleanup, pre-digest snapshots)."""
    report = {"dest": dest, "ok": True, "backups": [],
              "errors": [], "warnings": []}
    if not os.path.isdir(dest):
        report["ok"] = False
        report["errors"].append({"file": dest, "kind": "chain",
                                 "detail": "no such backup dir"})
        return report
    series = []
    for name in sorted(os.listdir(dest)):
        dirpath = os.path.join(dest, name)
        if not os.path.isdir(dirpath):
            continue
        mp = os.path.join(dirpath, MANIFEST)
        if not os.path.exists(mp) or os.path.exists(mp + ".tmp"):
            report["warnings"].append(
                {"dir": dirpath,
                 "detail": "half-written backup dir (skipped; the next "
                           "successful backup removes it)"})
            continue
        try:
            m = _read_backup_manifest(name, dirpath, strict=True)
        except vault.StorageCorruption as e:
            report["errors"].append({"file": e.path, "kind": e.kind,
                                     "detail": str(e)})
            continue
        if m is not None:
            series.append(m)
    series.sort(key=lambda m: m["seq"])

    for m in series:
        entry = {"dir": m["dir"], "seq": m["seq"], "type": m["type"],
                 "status": "ok"}
        if m["type"] == "full":
            try:
                problems = checkpoint.verify_snapshot(m["dir"])
            except vault.StorageCorruption as e:
                problems = [{"file": e.path, "kind": e.kind,
                             "detail": str(e)}]
            for p in problems:
                if p["kind"] == "undigested":
                    report["warnings"].append(p)
                else:
                    report["errors"].append(p)
                    entry["status"] = "corrupt"
        else:
            dpath = os.path.join(m["dir"], "delta.log")
            want = m.get("records")
            try:
                n = sum(1 for _ in Journal.replay(dpath))
            except vault.VaultError as e:
                report["errors"].append({"file": dpath, "kind": "delta",
                                         "detail": str(e)})
                entry["status"] = "corrupt"
                n = None
            if n is not None and want is not None and n != int(want):
                report["errors"].append(
                    {"file": dpath, "kind": "delta",
                     "detail": f"{n} of {want} records intact"})
                entry["status"] = "corrupt"
        report["backups"].append(entry)

    try:
        _chain_of(series, dest)
    except (FileNotFoundError, ValueError) as e:
        report["errors"].append({"file": dest, "kind": "chain",
                                 "detail": str(e)})
    report["ok"] = not report["errors"]
    return report
