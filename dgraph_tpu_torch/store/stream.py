"""Streaming maintenance layer: tablet-granular passes over the store.

Port of `dgraph_tpu/store/stream.py`: `iter_tablets`, `save_streaming`,
`write_fold`, `checkpoint_streaming` and `gc_superseded`, the same
passes. A clustered Alpha's replica heal hook (`LazyPreds.heal_cb`)
carries onto each new fold point.

Reference parity: Badger's Stream framework + the background jobs the
reference runs over it — posting-list rollups, raft snapshots, and
incremental backups all iterate the LSM key range in order, never
holding the whole store in memory (SURVEY §2.5, §5). This module is
that leg for the CSR block store: iterate predicate tablets in stable
(sorted) order, fault one in, process it, release it before the next —
so every write-shaped maintenance pass (MVCC fold/rollup, checkpoint
save, backup, RDF/JSON export) over an out-of-core store
(store/outofcore.py) holds at most `max(budget, largest_tablet)`
resident, byte-accounted through the same `_pd_nbytes` ledger the read
path evicts by.

The partitioned checkpoint writer reuses store/checkpoint.py's
per-tablet segment format verbatim (checkpoint.save_predicate), so a
streaming save is byte-identical per segment to an in-core save, and
the fold writer routes each tablet through the SAME
mvcc._materialize code path (restricted to one predicate, vocabulary
pinned to the full-fold union) — outputs are bit-identical to the
in-core rollup, just never all resident at once.

Observability: each pass emits `maintenance.tablet` spans and keeps the
`maintenance_resident_bytes` gauge + `maintenance_evictions_total`
counter fresh. The `pace` hook runs between tablets — the maintenance
scheduler (store/maintenance.py) uses it to sleep its pacing and to park
at its pause gate, which bounds how long a commit or a read contends
with a maintenance job: one tablet's work.
"""

from __future__ import annotations

import os

from dgraph_tpu_torch.store import checkpoint
from dgraph_tpu_torch.store.mvcc import (MVCCStore, _materialize, fold_preds,
                                         fold_vocab)
from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.utils import tracing
from dgraph_tpu_torch.utils.metrics import METRICS


def lazy_preds(store: Store):
    """The store's LazyPreds when it is out-of-core, else None."""
    from dgraph_tpu_torch.store.outofcore import LazyPreds
    preds = getattr(store, "preds", None)
    return preds if isinstance(preds, LazyPreds) else None


def _evicted(lazy) -> int:
    st = lazy.stats()  # locked accessor: serving threads fault/evict
    return st["evictions"] + st["releases"]


def _account(lazy, evicted_before: int) -> None:
    st = lazy.stats()
    METRICS.set_gauge("maintenance_resident_bytes",
                      st["resident_bytes"])
    delta = (st["evictions"] + st["releases"]) - evicted_before
    if delta > 0:
        METRICS.inc("maintenance_evictions_total", float(delta))


def iter_tablets(store: Store, release: bool = True, pace=None,
                 job: str = ""):
    """Yield (pred, PredicateData) in stable sorted order, one tablet
    resident at a time on an out-of-core store.

    Tablets that were already resident when the pass reached them (the
    serving path's hot set) are NOT released — only tablets this pass
    itself faulted in. Consumer work per tablet runs inside a
    `maintenance.tablet` span; `pace` runs between tablets."""
    lazy = lazy_preds(store)
    for pred in sorted(store.preds.keys()):
        was_resident = lazy.is_resident(pred) if lazy is not None else True
        evicted0 = _evicted(lazy) if lazy else 0
        with tracing.span("maintenance.tablet", pred=pred, job=job):
            pd = store.preds.get(pred)
            if pd is not None:
                yield pred, pd
        del pd
        if lazy is not None:
            if release and not was_resident:
                lazy.release(pred)
            _account(lazy, evicted0)
        if pace is not None:
            pace()


def save_streaming(store: Store, dirname: str, base_ts: int = 0,
                   compress: bool | None = None, pace=None,
                   job: str = "checkpoint") -> None:
    """checkpoint.save(), one tablet resident at a time: same segment
    files, same manifest fields — an out-of-core store is saved without
    ever holding more than budget + one tablet resident."""
    from dgraph_tpu_torch import native
    if compress is None:
        compress = native.HAVE_NATIVE
    os.makedirs(dirname, exist_ok=True)
    uids_crc = checkpoint.save_uids(store.uids, dirname, compress)
    preds_meta = {}
    for pred, pd in iter_tablets(store, pace=pace, job=job):
        preds_meta[pred] = checkpoint.save_predicate(dirname, pred, pd)
    checkpoint.write_manifest(dirname, checkpoint.manifest_doc(
        store.n_nodes, store.schema.to_text(), preds_meta, base_ts,
        compress, uids_crc=uids_crc))




def write_fold(mvcc: MVCCStore, dirname: str, plan=None,
               compress: bool | None = None, pace=None,
               job: str = "rollup",
               manifest_ts: int | None = None) -> tuple[int, tuple]:
    """Fold (newest fold point + pending delta layers) into a plain
    snapshot dir, ONE TABLET AT A TIME. Returns (new_ts, guard) for
    MVCCStore.install_fold. With no pending layers this degrades to a
    streaming save of the base (the builder round-trip is skipped so
    segments stay byte-identical to the base's own). `manifest_ts`
    overrides the base_ts recorded in the manifest (a full backup
    stamps its read watermark, which may sit above the newest commit)."""
    from dgraph_tpu_torch import native
    if compress is None:
        compress = native.HAVE_NATIVE
    if plan is None:
        plan = mvcc.fold_plan()
    _fold_ts, base, pending, new_ts, guard = plan
    stamp = new_ts if manifest_ts is None else manifest_ts
    if not pending:
        save_streaming(base, dirname, base_ts=stamp, compress=compress,
                       pace=pace, job=job)
        return new_ts, guard

    vocab = fold_vocab(base, pending)
    schema = base.schema.clone()
    os.makedirs(dirname, exist_ok=True)
    uids_crc = checkpoint.save_uids(vocab, dirname, compress)
    lazy = lazy_preds(base)
    preds_meta = {}
    for pred in fold_preds(base, pending):
        was_resident = lazy.is_resident(pred) if lazy is not None else True
        evicted0 = _evicted(lazy) if lazy else 0
        with tracing.span("maintenance.tablet", pred=pred, job=job):
            # the same fold code path the in-core rollup runs, restricted
            # to one predicate with the vocabulary pinned — per-tablet
            # output is bit-identical to the full materialize's slice
            folded = _materialize(base, pending, schema=schema,
                                  only={pred}, vocab=vocab)
            pd = folded.preds.get(pred)
            if pd is not None:
                preds_meta[pred] = checkpoint.save_predicate(
                    dirname, pred, pd)
        del folded, pd
        if lazy is not None:
            if not was_resident:
                lazy.release(pred)
            _account(lazy, evicted0)
        if pace is not None:
            pace()
    checkpoint.write_manifest(dirname, checkpoint.manifest_doc(
        int(len(vocab)), schema.to_text(), preds_meta, stamp, compress,
        uids_crc=uids_crc))
    return new_ts, guard


def _kept_dirs(root_dir: str, mvcc: MVCCStore) -> set:
    """ckpt subdirs under `root_dir` that a retained fold point of
    `mvcc` still faults tablets from."""
    keep = set()
    for _ts, st in mvcc.history_stores():
        lp = lazy_preds(st)
        if lp is not None and os.path.dirname(
                os.path.abspath(lp._dir)) == os.path.abspath(root_dir):
            keep.add(os.path.basename(lp._dir))
    return keep


def checkpoint_streaming(mvcc: MVCCStore, root_dir: str,
                         budget_bytes: int, pace=None,
                         job: str = "checkpoint") -> int:
    """Crash-safe streaming checkpoint of an out-of-core MVCC store:
    fold into a fresh `ckpt-<ts>` subdir tablet-at-a-time, reopen it
    OUT-OF-CORE, install it as the newest fold point, then flip the
    CURRENT pointer. Returns the new base_ts.

    Ordering matters for crash safety: the fold installs (guard-checked
    against stragglers) BEFORE the CURRENT flip — a crash in between
    recovers from the old snapshot + an untruncated WAL; an install
    refusal (FoldRaced) deletes the orphan subdir and leaves everything
    as it was, for the scheduler's retry. Superseded ckpt dirs survive
    the flip while an older fold point in MVCC history still faults
    tablets from them (gc drops the fold; gc_superseded sweeps the
    dir)."""
    import shutil

    from dgraph_tpu_torch.store.outofcore import open_out_of_core

    plan = mvcc.fold_plan()
    new_ts = plan[3]
    sub = checkpoint.begin_versioned(root_dir, new_ts)
    if sub is None:
        return new_ts  # CURRENT already names this exact fold
    subdir = os.path.join(root_dir, sub)
    try:
        write_fold(mvcc, subdir, plan=plan, pace=pace, job=job)
        new_base, _ts = open_out_of_core(subdir, budget_bytes)
        new_base.preds.root_dir = root_dir  # next fold writes beside it
        # a clustered Alpha's corruption-heal hook (replica
        # TabletSnapshot) carries onto every new fold point
        old_lazy = lazy_preds(mvcc.base)
        if old_lazy is not None:
            new_base.preds.heal_cb = old_lazy.heal_cb
        mvcc.install_fold(new_ts, new_base, plan[4])
    except BaseException:
        shutil.rmtree(subdir, ignore_errors=True)
        raise
    checkpoint.commit_versioned(root_dir, sub,
                                keep={sub} | _kept_dirs(root_dir, mvcc))
    return new_ts


_GC_RECLAIMED = 0  # cumulative bytes reclaimed (gauge backing store)


def gc_superseded(root_dir: str, mvcc: MVCCStore) -> int:
    """Remove superseded `ckpt-*` subdirs no retained MVCC fold point
    faults tablets from anymore; runs from the watermark gc path
    (Alpha._maybe_gc) once `mvcc.gc` dropped the fold that held one.
    Returns bytes reclaimed;
    cumulative total in the `checkpoint_gc_reclaimed_bytes` gauge."""
    import shutil
    global _GC_RECLAIMED

    cur = os.path.join(root_dir, "CURRENT")
    if not os.path.exists(cur):
        return 0
    with open(cur) as f:
        keep = {f.read().strip()} | _kept_dirs(root_dir, mvcc)
    reclaimed = 0
    for name in os.listdir(root_dir):
        if not name.startswith("ckpt-") or name in keep:
            continue
        d = os.path.join(root_dir, name)
        if not os.path.isdir(d):
            continue
        size = sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))
        shutil.rmtree(d, ignore_errors=True)
        reclaimed += size
    if reclaimed:
        _GC_RECLAIMED += reclaimed
        METRICS.set_gauge("checkpoint_gc_reclaimed_bytes", _GC_RECLAIMED)
    return reclaimed
