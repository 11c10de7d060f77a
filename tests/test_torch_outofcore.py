"""The port's out-of-core store, held to the reference.

`tests/test_outofcore.py`'s cases that need no maintenance scheduler or
cluster run against `dgraph_tpu_torch`: tablets fault in on first
touch and evict LRU under a budget smaller than the checkpoint, answers
equal the in-core store's and the reference's out-of-core store's over
the same checkpoint, membership and size hints never fault, concurrent
faults load once and keep exact accounting, a lazily-folding read view
folds only the tablets a query touches, a corrupt segment is a typed
refusal naming the file that leaves the other tablets serving, and an
out-of-core `Alpha` commits, checkpoints by streaming and reopens.
"""

import glob
import os
import random
import shutil
import threading

import numpy as np
import pytest

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.store import checkpoint as ref_ckpt
from dgraph_tpu.store.outofcore import _pd_nbytes as ref_pd_nbytes
from dgraph_tpu.store.outofcore import open_out_of_core as ref_open_ooc
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store import checkpoint, mvcc
from dgraph_tpu_torch.store.outofcore import _pd_nbytes, open_out_of_core
from dgraph_tpu_torch.store.vault import StorageCorruption
from test_torch_mvcc import assert_stores_equal

SCHEMA = """
name: string @index(exact) .
score: int @index(int) .
follows: [uid] @reverse .
likes: [uid] @reverse .
rates: [uid] @reverse .
knows: [uid] @reverse .
"""
QUERIES = [
    '{ q(func: eq(name, "p7")) { name follows { name } } }',
    '{ q(func: eq(name, "p9")) { likes { name score } } }',
    '{ q(func: eq(name, "p11")) { rates { name } } }',
    '{ q(func: eq(name, "p13")) { knows { ~knows (first: 3) { name } } } }',
    '{ q(func: eq(score, 5), first: 5, orderasc: name) { name } }',
]


def _engine(store):
    return Engine(store, device="cpu", device_threshold=10**9)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A checkpoint with several edge tablets that a budget below the
    disk size cannot hold at once."""
    rng = np.random.default_rng(3)
    a = Alpha(device="cpu", device_threshold=10**9)
    a.alter(SCHEMA)
    n = 500
    lines = [f'_:p{i} <name> "p{i}" .\n_:p{i} <score> "{i % 31}"^^<xs:int> .'
             for i in range(n)]
    for pred in ("follows", "likes", "rates", "knows"):
        for i in range(n):
            for j in rng.choice(n, 20, replace=False):
                if i != j:
                    lines.append(f"_:p{i} <{pred}> _:p{j} .")
    a.mutate(set_nquads="\n".join(lines))
    d = tmp_path_factory.mktemp("ooc")
    a.checkpoint_to(str(d))
    return str(d), a


def _disk_bytes(d):
    d = checkpoint.resolve(d)
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def test_query_under_budget_smaller_than_disk(ckpt_dir):
    d, a = ckpt_dir
    disk = _disk_bytes(d)
    budget = disk // 3
    store, base_ts = open_out_of_core(d, budget)
    ref_store, ref_ts = ref_open_ooc(d, budget)
    assert base_ts == ref_ts > 0
    lazy = store.preds
    assert lazy.resident_bytes == 0 and lazy.faults == 0
    eng = _engine(store)
    incore = _engine(a.mvcc.read_view(a.oracle.read_only_ts()))
    ref = RefEngine(ref_store, device_threshold=10**9)
    for q in QUERIES:
        assert eng.query(q) == incore.query(q) == ref.query(q), q
    assert lazy.faults >= 5 and lazy.evictions >= 1
    assert lazy.resident_bytes <= budget or len(lazy._resident) == 1
    assert disk > budget
    assert lazy.stats() == ref_store.preds.stats()
    faults = lazy.faults
    for q in QUERIES:
        assert eng.query(q) == incore.query(q), q
    assert lazy.faults > faults     # an evicted tablet faulted again


def test_membership_and_size_hints_do_not_fault(ckpt_dir):
    d, _a = ckpt_dir
    store, _ = open_out_of_core(d, 1 << 30)
    lazy = store.preds
    assert "follows" in lazy and "nope" not in lazy
    assert set(lazy.keys()) >= {"follows", "likes", "rates", "knows",
                                "name", "score"}
    hints = lazy.size_hints()
    assert hints == ref_open_ooc(d, 1 << 30)[0].preds.size_hints()
    assert all(nb > 0 for nb in hints.values())
    assert lazy.faults == 0


def test_faulted_tablets_equal_the_reference(ckpt_dir):
    d, _a = ckpt_dir
    store, _ = open_out_of_core(d, 1 << 30)
    ref_store, _ = ref_open_ooc(d, 1 << 30)
    for p in sorted(ref_store.preds.keys()):
        assert _pd_nbytes(store.preds[p]) == ref_pd_nbytes(ref_store.preds[p])
    assert_stores_equal(checkpoint.load(d)[0], ref_ckpt.load(d)[0])


def test_concurrent_faulting_single_load(ckpt_dir):
    d, _a = ckpt_dir
    store, _ = open_out_of_core(d, 1 << 30)
    lazy = store.preds
    out = []

    def touch(pred):
        out.append(lazy.get(pred).fwd.nnz)

    threads = [threading.Thread(target=touch, args=(p,))
               for p in ["follows"] * 8 + ["likes"] * 8]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(out)) <= 2
    assert lazy.faults == 2          # one load per predicate, not 16


def test_concurrent_fault_accounting_invariants(ckpt_dir):
    d, _a = ckpt_dir
    probe, _ = open_out_of_core(d, 1 << 30)
    sizes = [_pd_nbytes(probe.preds[p])
             for p in ("follows", "likes", "rates", "knows")]
    budget = int(sum(sizes) / 2)
    store, _ = open_out_of_core(d, budget)
    lazy = store.preds
    preds = ["follows", "likes", "rates", "knows", "name", "score"]
    errors = []

    def hammer(seed):
        rng = random.Random(seed)
        try:
            for _ in range(120):
                p = rng.choice(preds)
                if rng.random() < 0.15:
                    lazy.release(p)
                else:
                    assert lazy.get(p) is not None
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    with lazy._lock:
        assert set(lazy._sizes) == set(lazy._resident)
        assert lazy.resident_bytes == sum(lazy._sizes.values())
        assert lazy.resident_bytes == sum(
            _pd_nbytes(pd) for pd in lazy._resident.values())
        assert (lazy.resident_bytes <= lazy.budget_bytes
                or len(lazy._resident) == 1)
    assert lazy.peak_resident_bytes <= budget + max(sizes)


def test_release_drops_only_the_named_tablet(ckpt_dir):
    d, _a = ckpt_dir
    store, _ = open_out_of_core(d, 1 << 30)
    lazy = store.preds
    assert lazy.get("follows") is not None and lazy.is_resident("follows")
    before = lazy.resident_bytes
    assert lazy.release("follows")
    assert not lazy.is_resident("follows")
    assert lazy.resident_bytes < before
    assert not lazy.release("follows")   # idempotent
    assert lazy.get("follows").fwd.nnz > 0
    assert lazy.faults >= 2


def test_lazy_folding_read_view_materializes_only_touched(ckpt_dir,
                                                          tmp_path):
    d0, a_ref = ckpt_dir
    d = str(tmp_path / "p")
    shutil.copytree(d0, d)
    a = Alpha.open(d, device="cpu", device_threshold=10**9, sync=False,
                   memory_budget=_disk_bytes(d) // 3)
    a.mutate(set_nquads='_:m <name> "zz_above_fold" .')
    lazy = a.mvcc.base.preds
    faults0 = lazy.faults
    view = a.mvcc.read_view(a.oracle.read_only_ts())
    assert isinstance(view.preds, mvcc._LazyFoldPreds)
    out = a.query('{ q(func: eq(name, "zz_above_fold")) { name } }')
    assert out == {"q": [{"name": "zz_above_fold"}]}
    # the query read the view above: one tablet of six folded
    assert a.mvcc.read_view(a.oracle.read_only_ts()) is view
    assert 1 <= len(view.preds._done) < 6
    assert lazy.faults - faults0 < 6
    ref = _engine(a_ref.mvcc.read_view(a_ref.oracle.read_only_ts()))
    for q in QUERIES[:2]:
        assert a.query(q) == ref.query(q), q
    a.wal.close()


def test_corrupt_tablet_typed_refusal(ckpt_dir, tmp_path):
    d0, a_ref = ckpt_dir
    d = str(tmp_path / "p")
    shutil.copytree(d0, d)
    victim = glob.glob(os.path.join(checkpoint.resolve(d),
                                    "follows.*.fwd.indices.npy"))[0]
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        f.write(b"\x13\x37")
    store, _ = open_out_of_core(d, 1 << 30)
    with pytest.raises(StorageCorruption) as ei:
        store.preds.get("follows")
    assert os.path.basename(victim) in str(ei.value)
    assert store.preds.get("likes").fwd.nnz > 0
    # the refusal is not cached as a load: the next touch reads again
    with pytest.raises(StorageCorruption):
        store.preds.get("follows")
    assert not store.preds.is_resident("follows")


def test_alpha_open_with_memory_budget_streams_checkpoints(ckpt_dir,
                                                           tmp_path):
    """An out-of-core Alpha serves, commits above the lazy base,
    checkpoints by streaming one tablet at a time into a new versioned
    snapshot (equal to the in-core fold and loadable by the reference),
    and reopens to the same answers."""
    d0, a_ref = ckpt_dir
    d = str(tmp_path / "p")
    shutil.copytree(d0, d)
    budget = _disk_bytes(d) // 3
    a = Alpha.open(d, device="cpu", device_threshold=10**9,
                   memory_budget=budget)
    ref = _engine(a_ref.mvcc.read_view(a_ref.oracle.read_only_ts()))
    assert a.query(QUERIES[0]) == ref.query(QUERIES[0])
    a.mutate(set_nquads='_:new <name> "zz_new" .\n_:new <follows> <0x1> .')
    out = a.query('{ q(func: eq(name, "zz_new")) { name follows { name } } }')
    assert out == {"q": [{"name": "zz_new", "follows": [{"name": "p0"}]}]}
    want = mvcc._materialize(a.mvcc.base, list(a.mvcc.layers))
    ts = a.checkpoint_to(d)
    assert a.mvcc.base_ts == ts
    lazy = a.mvcc.base.preds
    assert lazy.peak_resident_bytes <= budget + max(
        lazy.size_hints().values())
    assert_stores_equal(checkpoint.load(d)[0], ref_ckpt.load(d)[0])
    got, _ = checkpoint.load(d)
    np.testing.assert_array_equal(got.uids, want.uids)
    for p in want.preds:
        np.testing.assert_array_equal(got.preds[p].fwd.indices
                                      if got.preds[p].fwd is not None
                                      else [], want.preds[p].fwd.indices
                                      if want.preds[p].fwd is not None
                                      else [])
    a.wal.close()
    b = Alpha.open(d, device="cpu", device_threshold=10**9,
                   memory_budget=budget)
    for q in QUERIES + ['{ q(func: eq(name, "zz_new")) { follows { name } } }']:
        assert b.query(q) == a.query(q), q
