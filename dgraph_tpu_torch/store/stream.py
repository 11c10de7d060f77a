"""Streaming maintenance layer: tablet-granular passes over the store.

Port of `dgraph_tpu/store/stream.py`: `iter_tablets`, `save_streaming`,
`write_fold`, `checkpoint_streaming` and `gc_superseded`, the same
passes without the reference's `maintenance.tablet` spans and metrics
gauges (tracing and the metrics registry are ROADMAP Queue 1 item 9).

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
"""

from __future__ import annotations

import os

from dgraph_tpu_torch.store import checkpoint
from dgraph_tpu_torch.store.mvcc import (MVCCStore, _materialize, fold_preds,
                                         fold_vocab)
from dgraph_tpu_torch.store.store import Store


def lazy_preds(store: Store):
    """The store's LazyPreds when it is out-of-core, else None."""
    from dgraph_tpu_torch.store.outofcore import LazyPreds
    preds = getattr(store, "preds", None)
    return preds if isinstance(preds, LazyPreds) else None


def iter_tablets(store: Store, release: bool = True):
    """Yield (pred, PredicateData) in stable sorted order, one tablet
    resident at a time on an out-of-core store.

    Tablets that were already resident when the pass reached them (the
    serving path's hot set) are NOT released — only tablets this pass
    itself faulted in."""
    lazy = lazy_preds(store)
    for pred in sorted(store.preds.keys()):
        was_resident = lazy.is_resident(pred) if lazy is not None else True
        pd = store.preds.get(pred)
        if pd is not None:
            yield pred, pd
        del pd
        if lazy is not None and release and not was_resident:
            lazy.release(pred)


def save_streaming(store: Store, dirname: str, base_ts: int = 0,
                   compress: bool | None = None) -> None:
    """checkpoint.save(), one tablet resident at a time: same segment
    files, same manifest fields — an out-of-core store is saved without
    ever holding more than budget + one tablet resident."""
    from dgraph_tpu_torch import native
    if compress is None:
        compress = native.HAVE_NATIVE
    os.makedirs(dirname, exist_ok=True)
    uids_crc = checkpoint.save_uids(store.uids, dirname, compress)
    preds_meta = {}
    for pred, pd in iter_tablets(store):
        preds_meta[pred] = checkpoint.save_predicate(dirname, pred, pd)
    checkpoint.write_manifest(dirname, checkpoint.manifest_doc(
        store.n_nodes, store.schema.to_text(), preds_meta, base_ts,
        compress, uids_crc=uids_crc))


def write_fold(mvcc: MVCCStore, dirname: str, plan=None,
               compress: bool | None = None) -> tuple[int, tuple]:
    """Fold (newest fold point + pending delta layers) into a plain
    snapshot dir, ONE TABLET AT A TIME. Returns (new_ts, guard) for
    MVCCStore.install_fold. With no pending layers this degrades to a
    streaming save of the base (the builder round-trip is skipped so
    segments stay byte-identical to the base's own)."""
    from dgraph_tpu_torch import native
    if compress is None:
        compress = native.HAVE_NATIVE
    if plan is None:
        plan = mvcc.fold_plan()
    _fold_ts, base, pending, new_ts, guard = plan
    if not pending:
        save_streaming(base, dirname, base_ts=new_ts, compress=compress)
        return new_ts, guard

    vocab = fold_vocab(base, pending)
    schema = base.schema.clone()
    os.makedirs(dirname, exist_ok=True)
    uids_crc = checkpoint.save_uids(vocab, dirname, compress)
    lazy = lazy_preds(base)
    preds_meta = {}
    for pred in fold_preds(base, pending):
        was_resident = lazy.is_resident(pred) if lazy is not None else True
        # the same fold code path the in-core rollup runs, restricted to
        # one predicate with the vocabulary pinned — per-tablet output
        # is bit-identical to the full materialize's slice
        folded = _materialize(base, pending, schema=schema,
                              only={pred}, vocab=vocab)
        pd = folded.preds.get(pred)
        if pd is not None:
            preds_meta[pred] = checkpoint.save_predicate(dirname, pred, pd)
        del folded, pd
        if lazy is not None and not was_resident:
            lazy.release(pred)
    checkpoint.write_manifest(dirname, checkpoint.manifest_doc(
        int(len(vocab)), schema.to_text(), preds_meta, new_ts, compress,
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
                         budget_bytes: int) -> int:
    """Crash-safe streaming checkpoint of an out-of-core MVCC store:
    fold into a fresh `ckpt-<ts>` subdir tablet-at-a-time, reopen it
    OUT-OF-CORE, install it as the newest fold point, then flip the
    CURRENT pointer. Returns the new base_ts.

    Ordering matters for crash safety: the fold installs (guard-checked
    against stragglers) BEFORE the CURRENT flip — a crash in between
    recovers from the old snapshot + an untruncated WAL; an install
    refusal (FoldRaced) deletes the orphan subdir and leaves everything
    as it was, for the caller's retry. Superseded ckpt dirs survive the
    flip while an older fold point in MVCC history still faults tablets
    from them (gc drops the fold; gc_superseded sweeps the dir)."""
    import shutil

    from dgraph_tpu_torch.store.outofcore import open_out_of_core

    plan = mvcc.fold_plan()
    new_ts = plan[3]
    sub = checkpoint.begin_versioned(root_dir, new_ts)
    if sub is None:
        return new_ts  # CURRENT already names this exact fold
    subdir = os.path.join(root_dir, sub)
    try:
        write_fold(mvcc, subdir, plan=plan)
        new_base, _ts = open_out_of_core(subdir, budget_bytes)
        new_base.preds.root_dir = root_dir  # next fold writes beside it
        mvcc.install_fold(new_ts, new_base, plan[4])
    except BaseException:
        shutil.rmtree(subdir, ignore_errors=True)
        raise
    checkpoint.commit_versioned(root_dir, sub,
                                keep={sub} | _kept_dirs(root_dir, mvcc))
    return new_ts


def gc_superseded(root_dir: str, mvcc: MVCCStore) -> int:
    """Remove superseded `ckpt-*` subdirs no retained MVCC fold point
    faults tablets from anymore; runs from the watermark gc path
    (Alpha._maybe_gc) once `mvcc.gc` dropped the fold that held one.
    Returns bytes reclaimed."""
    import shutil

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
    return reclaimed
