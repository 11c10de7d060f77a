"""The port's write-ahead log and crash recovery, held to the reference.

`tests/test_wal.py`'s cases run against `dgraph_tpu_torch`'s `WAL` and
`Alpha` (on the CPU): the record round trip, torn tails dropped and cut
before the next append, truncation after a checkpoint, recovery of
unsnapshotted commits, a SIGKILLed child that loses no acknowledged
commit, idle restarts, partial checkpoint dirs and no-op re-checkpoints.
Logs written by either package replay in the other to equal mutations
(every value kind the codec tags: datetimes, geo values, facets).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dgraph_tpu.store import wal as ref_wal
from dgraph_tpu.store.geo import parse_geo as ref_parse_geo
from dgraph_tpu.store.mvcc import Mutation as RefMutation
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store import checkpoint
from dgraph_tpu_torch.store import wal as port_wal
from dgraph_tpu_torch.store.geo import parse_geo
from dgraph_tpu_torch.store.mvcc import Mutation
from dgraph_tpu_torch.store.wal import WAL, replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = "name: string @index(exact) .\nfriend: [uid] @reverse .\n"


def _open(p, **kw):
    return Alpha.open(p, device="cpu", **kw)


def test_wal_roundtrip(tmp_path):
    path = str(tmp_path / "wal.log")
    w = WAL(path)
    m1 = Mutation(edge_sets=[(1, "friend", 2, {"since": 2004})],
                  val_sets=[(1, "name", "alice", "", None)])
    m2 = Mutation(edge_dels=[(1, "friend", 2)],
                  val_dels=[(1, "name", None, "")])
    w.append(m1, 10)
    w.append_schema(SCHEMA, 11)
    w.append(m2, 12)
    w.append_drop(13)
    w.append_drop_attr("name", 14)
    w.close()
    recs = list(replay(path))
    assert [(ts, kind) for ts, kind, _ in recs] == [
        (10, "mut"), (11, "schema"), (12, "mut"), (13, "drop"),
        (14, "drop_attr")]
    assert recs[0][2].edge_sets == [(1, "friend", 2, {"since": 2004})]
    assert recs[0][2].val_sets == [(1, "name", "alice", "", None)]
    assert recs[1][2] == SCHEMA
    assert recs[2][2].edge_dels == [(1, "friend", 2)]
    assert recs[4][2] == "name"


@pytest.mark.parametrize("cut", [7, 1, 13])
def test_wal_torn_tail_dropped(tmp_path, cut):
    path = str(tmp_path / "wal.log")
    w = WAL(path)
    w.append(Mutation(val_sets=[(1, "name", "a", "", None)]), 5)
    w.append(Mutation(val_sets=[(2, "name", "b", "", None)]), 6)
    w.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - cut)  # torn mid-record, as a crash leaves it
    recs = list(replay(path))
    assert len(recs) == 1 and recs[0][0] == 5
    # reopening for append cuts the torn bytes first
    WAL(path).close()
    assert os.path.getsize(path) == port_wal._valid_end(path)


def test_wal_truncate_keeps_tail(tmp_path):
    path = str(tmp_path / "wal.log")
    w = WAL(path)
    for ts in (5, 6, 7):
        w.append(Mutation(val_sets=[(ts, "name", f"v{ts}", "", None)]), ts)
    w.truncate(6)
    w.append(Mutation(val_sets=[(8, "name", "v8", "", None)]), 8)
    w.close()
    assert [ts for ts, _k, _o in replay(path)] == [7, 8]


def test_alpha_recovers_unsnapshotted_commits(tmp_path):
    p = str(tmp_path / "p")
    a = _open(p)
    a.alter(SCHEMA)
    a.mutate(set_nquads='_:a <name> "alice" .\n_:b <name> "bob" .\n'
                        '_:a <friend> _:b .')
    b = _open(p)  # no checkpoint: a crash is just a reopen
    out = b.query('{ q(func: eq(name, "alice")) { name friend { name } } }')
    assert out == {"q": [{"name": "alice", "friend": [{"name": "bob"}]}]}
    b.mutate(set_nquads='_:c <name> "carol" .')
    out = b.query('{ q(func: has(name)) { name } }')
    assert sorted(r["name"] for r in out["q"]) == ["alice", "bob", "carol"]


def test_alpha_checkpoint_truncates_and_recovers(tmp_path):
    p = str(tmp_path / "p")
    a = _open(p)
    a.alter(SCHEMA)
    a.mutate(set_nquads='_:a <name> "alice" .')
    ts = a.checkpoint_to(p)
    assert [t for t, _k, _o in replay(os.path.join(p, "wal.log"))] == []
    a.mutate(set_nquads='_:b <name> "bob" .')  # post-checkpoint tail
    assert all(t > ts for t, _k, _o in replay(os.path.join(p, "wal.log")))
    b = _open(p)
    out = b.query('{ q(func: has(name)) { name } }')
    assert sorted(r["name"] for r in out["q"]) == ["alice", "bob"]


def test_alpha_drop_all_survives_restart(tmp_path):
    p = str(tmp_path / "p")
    a = _open(p)
    a.alter(SCHEMA)
    a.mutate(set_nquads='_:a <name> "alice" .')
    a.drop_all()
    b = _open(p)
    assert b.query('{ q(func: has(name)) { name } }') == {"q": []}


_CHILD = r"""
import sys
from dgraph_tpu_torch.server.api import Alpha

p = sys.argv[1]
a = Alpha.open(p, device="cpu")
a.alter("name: string @index(exact) .")
i = 0
while True:
    a.mutate(set_nquads=f'_:x <name> "row{i}" .')
    print(i, flush=True)   # ack AFTER commit returned
    i += 1
"""


def test_kill_during_load_loses_no_acked_commit(tmp_path):
    """SIGKILL an Alpha mid-load; every commit it ACKED survives."""
    p = str(tmp_path / "p")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, p],
                            stdout=subprocess.PIPE, text=True, cwd=ROOT,
                            env=env)
    acked = []
    deadline = time.time() + 120
    while len(acked) < 12 and time.time() < deadline:
        line = proc.stdout.readline()
        if line.strip().isdigit():
            acked.append(int(line))
    proc.kill()
    proc.wait()
    assert len(acked) >= 12, f"child too slow: {len(acked)} acks"
    b = _open(p)
    names = {r["name"] for r in
             b.query('{ q(func: has(name)) { name } }')["q"]}
    missing = [i for i in acked if f"row{i}" not in names]
    assert not missing, f"acked commits lost after kill: {missing}"


def test_idle_restart_preserves_base_ts(tmp_path):
    p = str(tmp_path / "p")
    a = _open(p)
    a.alter(SCHEMA)
    a.mutate(set_nquads='_:a <name> "alice" .')
    ts1 = a.checkpoint_to(p)
    assert ts1 > 0
    b = _open(p)
    b.query('{ q(func: has(name)) { name } }')
    ts2 = b.checkpoint_to(p)
    assert ts2 >= ts1
    c = _open(p)
    assert c.oracle.read_only_ts() > ts1
    assert c.query('{ q(func: has(name)) { name } }') == {
        "q": [{"name": "alice"}]}


def test_torn_tail_then_append_survives_two_restarts(tmp_path):
    p = str(tmp_path / "p")
    a = _open(p)
    a.alter(SCHEMA)
    a.mutate(set_nquads='_:a <name> "alice" .')
    wal_path = os.path.join(p, "wal.log")
    with open(wal_path, "r+b") as f:
        f.seek(0, 2)
        f.write(b"DGW1\x99\x00\x00\x00")  # torn record: header, no payload
    b = _open(p)  # restart 1 drops the torn tail
    b.mutate(set_nquads='_:b <name> "bob" .')
    out = b.query('{ q(func: has(name)) { name } }')
    assert sorted(r["name"] for r in out["q"]) == ["alice", "bob"]
    c = _open(p)  # restart 2: bob is still there
    out = c.query('{ q(func: has(name)) { name } }')
    assert sorted(r["name"] for r in out["q"]) == ["alice", "bob"]


def test_partial_checkpoint_dir_ignored(tmp_path):
    p = str(tmp_path / "p")
    a = _open(p)
    a.alter(SCHEMA)
    a.mutate(set_nquads='_:a <name> "alice" .')
    a.checkpoint_to(p)
    a.mutate(set_nquads='_:b <name> "bob" .')
    os.makedirs(os.path.join(p, "ckpt-9999999999999999"))
    with open(os.path.join(p, "ckpt-9999999999999999", "manifest.json"),
              "w") as f:
        f.write("{ this is not json")
    b = _open(p)
    out = b.query('{ q(func: has(name)) { name } }')
    assert sorted(r["name"] for r in out["q"]) == ["alice", "bob"]


def test_idle_recheckpoint_is_noop(tmp_path):
    p = str(tmp_path / "p")
    a = _open(p)
    a.alter("name: string .")
    a.mutate(set_nquads='_:x <name> "x" .')
    ts = a.checkpoint_to(p)
    sub = tmp_path / "p" / f"ckpt-{ts:016d}"
    mtime = os.path.getmtime(sub / "manifest.json")
    assert a.checkpoint_to(p) == ts
    assert os.path.getmtime(sub / "manifest.json") == mtime
    store, bts = checkpoint.load(p)
    assert bts == ts and store.n_nodes == 1


# -- logs cross between the packages -------------------------------------------

GEO = '{"type":"Point","coordinates":[2.5,48.5]}'


def _records(geo, dt):
    """(kind, ts, payload) records over every value kind the codec tags."""
    return [
        ("mut", 5, dict(
            edge_sets=[(1, "friend", 2, {"since": 2004, "w": 0.5}),
                       (1, "friend", 3, None)],
            val_sets=[(1, "name", "alice", "", None),
                      (1, "nick", "al", "en", {"src": "x"}),
                      (2, "age", 31, "", None),
                      (2, "score", 1.25, "", None),
                      (2, "flag", True, "", None),
                      (3, "born", dt, "", None),
                      (3, "loc", geo, "", None)],
            touch_uids=[9])),
        ("schema", 6, SCHEMA),
        ("mut", 7, dict(edge_dels=[(1, "friend", 2), (1, "friend", None)],
                        val_dels=[(1, "name", None, ""),
                                  (2, "age", None, "*")])),
        ("drop_attr", 8, "nick"),
        ("pend", 9, dict(val_sets=[(4, "name", "dan", "", None)])),
        ("dec", 9, True),
        ("drop", 10, None),
    ]


def _write(wal_cls, mut_cls, path, records):
    """Write `records` through `wal_cls`. Staged-commit records (pend and
    its decision) are the cluster's, which the port does not write yet:
    the reference's WAL appends those to the same file."""
    for kind, ts, obj in records:
        cls, mcls = ((ref_wal.WAL, RefMutation) if kind in ("pend", "dec")
                     else (wal_cls, mut_cls))
        w = cls(path, sync=False)
        if kind == "mut":
            w.append(mcls(**obj), ts)
        elif kind == "schema":
            w.append_schema(obj, ts)
        elif kind == "drop_attr":
            w.append_drop_attr(obj, ts)
        elif kind == "pend":
            w.append_pend(mcls(**obj), ts)
        elif kind == "dec":
            w.append_decision(ts, obj)
        else:
            w.append_drop(ts)
        w.close()


def _norm_rec(rec):
    ts, kind, obj = rec
    if hasattr(obj, "edge_sets"):
        def v(x):
            if hasattr(x, "gj"):
                return ("geo", x.gj)
            if isinstance(x, np.datetime64):
                return ("dt", str(x))
            return x
        obj = (obj.edge_sets, obj.edge_dels,
               [(s, p, v(x), lang, f) for s, p, x, lang, f in obj.val_sets],
               obj.val_dels, obj.touch_uids)
    return ts, kind, obj


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_logs_replay_across_packages(tmp_path, writer):
    dt = np.datetime64("1999-12-31T23:59:58.000001")
    port_recs = _records(parse_geo(GEO), dt)
    ref_recs = _records(ref_parse_geo(GEO), dt)
    path = str(tmp_path / "wal.log")
    if writer == "port":
        _write(WAL, Mutation, path, port_recs)
    else:
        _write(ref_wal.WAL, RefMutation, path, ref_recs)
    got = [_norm_rec(r) for r in replay(path)]
    want = [_norm_rec(r) for r in ref_wal.replay(path)]
    assert got == want
    assert [_norm_rec(r) for r in port_wal.resolved_replay(path)] == \
        [_norm_rec(r) for r in ref_wal.resolved_replay(path)]
    # the bytes a writer leaves are the other's bytes
    other = str(tmp_path / "other.log")
    if writer == "port":
        _write(ref_wal.WAL, RefMutation, other, ref_recs)
    else:
        _write(WAL, Mutation, other, port_recs)
    assert open(path, "rb").read() == open(other, "rb").read()


def test_reference_wal_boots_port_alpha(tmp_path):
    """A p dir the reference's Alpha wrote (checkpoint + WAL tail with a
    drop_attr) boots the port's Alpha to the same answers, and back."""
    from dgraph_tpu.server.api import Alpha as RefAlpha
    p = str(tmp_path / "p")
    r = RefAlpha.open(p, device_threshold=10**9, sync=False)
    r.alter(SCHEMA + "age: int @index(int) .\n")
    r.mutate(set_nquads='_:a <name> "alice" .\n_:b <name> "bob" .\n'
                        '_:a <friend> _:b .\n_:a <age> "30"^^<xs:int> .')
    r.checkpoint_to(p)
    r.mutate(set_nquads='_:c <name> "carol" .\n_:c <friend> _:a .')
    r.drop_attr("age")
    r.wal.close()
    q = ('{ q(func: has(name), orderasc: name) { name age friend { name } '
         '~friend { name } } }')
    a = _open(p, device_threshold=10**9)
    assert a.query(q) == RefAlpha.open(p, device_threshold=10**9,
                                       sync=False).query(q)
    a.mutate(set_nquads='_:d <name> "dan" .\n_:d <friend> _:d .')
    a.checkpoint_to(p)
    a.mutate(set_nquads='_:e <name> "eve" .')
    a.wal.close()
    assert _open(p).query(q) == RefAlpha.open(
        p, device_threshold=10**9, sync=False).query(q)
