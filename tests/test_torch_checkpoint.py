"""The port's checkpoints and at-rest encryption, held to the reference.

Checkpoints cross both ways: a snapshot either package writes loads in
the other to an equal store (array for array, `test_torch_mvcc`'s
comparison) and to equal query bytes over the LDBC IC mix at sf 0.02.
A crc mismatch raises `StorageCorruption` naming the file, and
`tests/test_vault.py`'s cases that pass in the reference run against
the port's `vault`, `WAL` and `Alpha`. Tolerance: exact.
"""

import glob
import os

import numpy as np
import pytest

from dgraph_tpu.engine import Engine as RefEngine
from dgraph_tpu.models import ldbc as ref_ldbc
from dgraph_tpu.store import checkpoint as ref_ckpt
from dgraph_tpu.store import vault as ref_vault
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store import checkpoint, vault
from dgraph_tpu_torch.store.mvcc import Mutation
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.store.wal import WAL, replay
from test_torch_mvcc import _base_triples, _build, assert_stores_equal

KEY = bytes(range(32))
KEY2 = bytes(range(1, 33))


@pytest.fixture(autouse=True)
def _clean_key():
    """Vault state is process-global in both packages."""
    vault.set_key(None)
    ref_vault.set_key(None)
    yield
    vault.set_key(None)
    ref_vault.set_key(None)


def _stores(seed):
    rng = np.random.default_rng(seed)
    edges, values = _base_triples(rng)
    return (_build(StoreBuilder, parse_schema, edges, values),
            _build(RefBuilder, ref_parse_schema, edges, values))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compress", [True, False])
def test_checkpoints_cross_both_ways(tmp_path, seed, compress):
    port, ref = _stores(seed)
    checkpoint.save(port, str(tmp_path / "port"), base_ts=7,
                    compress=compress)
    ref_ckpt.save(ref, str(tmp_path / "ref"), base_ts=7, compress=compress)
    # the same files, byte for byte
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    for n in names:
        assert open(tmp_path / "port" / n, "rb").read() == \
            open(tmp_path / "ref" / n, "rb").read(), n
    got, ts = checkpoint.load(str(tmp_path / "ref"))
    want, rts = ref_ckpt.load(str(tmp_path / "port"))
    assert ts == rts == 7
    assert_stores_equal(got, want)
    assert_stores_equal(checkpoint.load(str(tmp_path / "port"))[0],
                        ref_ckpt.load(str(tmp_path / "ref"))[0])


@pytest.fixture(scope="module")
def ldbc_pair():
    g = ldbc.generate(sf=0.02, seed=9)
    b = StoreBuilder()
    ldbc.load_into(b, g)
    rb = RefBuilder()
    rb.schema.update(ref_parse_schema(ldbc.SCHEMA))
    for (s, o), w in zip(g.knows.tolist(), g.knows_weight.tolist()):
        rb.add_edge(s, "knows", o, facets={"weight": float(w)})
    for pred in ("has_creator", "reply_of", "has_tag", "has_member",
                 "container_of", "likes", "works_at"):
        pairs = getattr(g, pred)
        rb.add_edges(pred, pairs[:, 0], pairs[:, 1])
    for i, u in enumerate(g.person_uids.tolist()):
        rb.add_value(u, "first_name", g.first_name[i])
        rb.add_value(u, "last_name", g.last_name[i])
        rb.add_value(u, "city", g.city[i])
        rb.add_value(u, "birthday_year", int(g.birthday_year[i]))
    msg = np.concatenate([g.post_uids, g.comment_uids])
    for u, ts in zip(msg.tolist(), g.creation_ts.tolist()):
        rb.add_value(u, "creation_ts", int(ts))
    for i, u in enumerate(g.tag_uids.tolist()):
        rb.add_value(u, "tag_name", ldbc.TAG_NAMES[i])
    for i, u in enumerate(g.forum_uids.tolist()):
        rb.add_value(u, "forum_title", f"forum_{i}")
    for i, u in enumerate(g.org_uids.tolist()):
        rb.add_value(u, "org_name", f"org_{i}")
    return g, b.finalize(), rb.finalize()


def test_ldbc_checkpoints_cross_to_equal_query_bytes(tmp_path, ldbc_pair):
    g, port, ref = ldbc_pair
    checkpoint.save_versioned(port, str(tmp_path / "port"), base_ts=3)
    ref_ckpt.save_versioned(ref, str(tmp_path / "ref"), base_ts=3)
    got, _ = checkpoint.load(str(tmp_path / "ref"))
    want, _ = ref_ckpt.load(str(tmp_path / "port"))
    assert_stores_equal(got, want)
    assert ldbc.ic_templates(g) == ref_ldbc.ic_templates(g)
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    eng = Engine(got, device="cpu", device_threshold=0)
    ref_eng = RefEngine(want, device_threshold=10**9)
    for name, q in queries.items():
        assert eng.query_bytes(q) == ref_eng.query_bytes(q), name


def test_crc_corruption_names_the_file(tmp_path):
    port, _ref = _stores(3)
    d = str(tmp_path / "c")
    checkpoint.save_versioned(port, d, base_ts=5)
    victim = glob.glob(os.path.join(checkpoint.resolve(d),
                                    "friend.*.fwd.indices.npy"))[0]
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        f.write(b"\x13\x37")
    with pytest.raises(vault.StorageCorruption) as ei:
        checkpoint.load(d)
    assert os.path.basename(victim) in str(ei.value)
    assert vault.StorageCorruption.retryable
    problems = checkpoint.verify_snapshot(d)
    assert [os.path.basename(p["file"]) for p in problems] == \
        [os.path.basename(victim)]
    assert problems == [dict(x, file=x["file"]) for x in
                        ref_ckpt.verify_snapshot(d)]
    # a manifest that will not decode is refused the same way
    mp = os.path.join(checkpoint.resolve(d), "manifest.json")
    with open(mp, "wb") as f:
        f.write(b"{ not json")
    with pytest.raises(vault.StorageCorruption, match="manifest.json"):
        checkpoint.load(d)


# -- test_vault.py's cases on the port ------------------------------------------

def test_primitives_roundtrip_and_tamper():
    vault.set_key(KEY)
    ct = vault.encrypt(b"hello postings")
    assert ct[:4] == vault.MAGIC and b"hello" not in ct
    assert vault.decrypt(ct) == b"hello postings"
    assert vault.decrypt(b"plain old bytes") == b"plain old bytes"
    bad = ct[:-1] + bytes([ct[-1] ^ 1])
    with pytest.raises(vault.VaultError):
        vault.decrypt(bad)
    vault.set_key(KEY2)
    with pytest.raises(vault.VaultError):
        vault.decrypt(ct)
    vault.set_key(None)
    with pytest.raises(vault.VaultError, match="no key"):
        vault.decrypt(ct)
    # a blob either package seals opens in the other
    vault.set_key(KEY)
    ref_vault.set_key(KEY)
    assert ref_vault.decrypt(vault.encrypt(b"x", aad=b"a"), aad=b"a") == b"x"
    assert vault.decrypt(ref_vault.encrypt(b"y")) == b"y"


def test_chunked_large_blob(monkeypatch, tmp_path):
    monkeypatch.setattr(vault, "_CHUNK", 1000)
    vault.set_key(KEY)
    data = os.urandom(3500)
    ct = vault.encrypt(data)
    assert ct[:4] == vault.MAGIC_C
    assert vault.decrypt(ct) == data
    bad = bytearray(ct)
    bad[len(ct) // 2] ^= 1
    with pytest.raises(vault.VaultError):
        vault.decrypt(bytes(bad))
    with pytest.raises(vault.VaultError):
        vault.decrypt(ct[:-5])
    arr = np.arange(2000, dtype=np.int64)
    p = str(tmp_path / "a.npy")
    vault.save_np(p, arr)
    assert open(p, "rb").read(4) == vault.MAGIC_C
    np.testing.assert_array_equal(vault.load_np(p), arr)


def test_strict_mode_rejects_plaintext(tmp_path):
    plain = tmp_path / "plain.npy"
    np.save(str(plain), np.arange(4))
    blob = tmp_path / "blob"
    blob.write_bytes(b"not encrypted")
    vault.set_key(KEY, strict=True)
    with pytest.raises(vault.VaultError, match="strict"):
        vault.load_np(str(plain))
    with pytest.raises(vault.VaultError, match="strict"):
        vault.read_bytes(str(blob))
    vault.set_key(KEY)
    np.testing.assert_array_equal(vault.load_np(str(plain)), np.arange(4))
    assert vault.read_bytes(str(blob)) == b"not encrypted"


def test_magic_collision_escape(tmp_path):
    p = str(tmp_path / "b")
    for prefix in (vault.MAGIC, vault.MAGIC_C, vault.MAGIC_P):
        data = prefix + b"\x01\x02\x03"
        vault.set_key(None)
        vault.write_bytes(p, data)
        assert vault.read_bytes(p) == data
        vault.set_key(KEY)
        vault.write_bytes(p, data)
        assert vault.read_bytes(p) == data
        vault.set_key(None)


def test_wal_record_reorder_rejected(tmp_path):
    from dgraph_tpu_torch.store.wal import _scan
    vault.set_key(KEY)
    path = str(tmp_path / "wal.log")
    w = WAL(path, sync=False)
    w.append(Mutation(edge_sets=[(1, "friend", 2, None)]), 5)
    w.append(Mutation(edge_sets=[(2, "friend", 3, None)]), 6)
    w.close()
    data = open(path, "rb").read()
    recs, prev = [], 0
    for off, _payload, _legacy in _scan(data):
        recs.append(data[prev:off])
        prev = off
    open(path, "wb").write(recs[1] + recs[0])
    with pytest.raises(vault.VaultError):
        list(replay(path))


def test_chunk_reorder_and_truncation_rejected(monkeypatch):
    import struct
    monkeypatch.setattr(vault, "_CHUNK", 1000)
    vault.set_key(KEY)
    data = os.urandom(2000)
    ct = vault.encrypt(data)
    assert vault.decrypt(ct) == data
    off, chunks = 4, []
    while off < len(ct):
        (clen,) = struct.unpack_from("<Q", ct, off)
        chunks.append(ct[off:off + 8 + 12 + clen])
        off += 8 + 12 + clen
    with pytest.raises(vault.VaultError):
        vault.decrypt(ct[:4] + chunks[1] + chunks[0])
    with pytest.raises(vault.VaultError):
        vault.decrypt(ct[:4] + chunks[0])


def test_legacy_no_aad_records_still_replay(tmp_path):
    import struct
    import zlib
    vault.set_key(KEY)
    path = str(tmp_path / "wal.log")
    doc = b'{"ts":5,"m":{"es":[[1,"friend",2,null]],"ed":[],"vs":[],"vd":[]}}'
    payload = vault.encrypt(doc)
    rec = b"DGW1" + struct.pack("<II", len(payload),
                                zlib.crc32(payload)) + payload
    open(path, "wb").write(rec)
    got = list(replay(path))
    assert got[0][0] == 5 and got[0][2].edge_sets[0][1] == "friend"


def test_key_sizes_and_key_file(tmp_path):
    with pytest.raises(vault.VaultError):
        vault.set_key(b"short")
    kf = tmp_path / "key"
    kf.write_bytes(KEY + b"\n")
    vault.load_key_file(str(kf))
    assert vault.active()


def test_key_without_cryptography_raises(monkeypatch):
    """A key set where `cryptography` is missing raises; nothing is ever
    written in plaintext instead."""
    import builtins
    real = builtins.__import__

    def no_crypto(name, *a, **kw):
        if name.startswith("cryptography"):
            raise ImportError("no cryptography here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_crypto)
    with pytest.raises(ImportError):
        vault.set_key(KEY)
    assert not vault.active()


def test_encrypted_checkpoint_roundtrip(tmp_path):
    """Every file of a sealed snapshot is ciphertext; it loads with the
    key, in both packages; without the key or with another one both
    packages refuse it the same way."""
    vault.set_key(KEY)
    ref_vault.set_key(KEY)
    a = Alpha(device="cpu", device_threshold=10**9)
    a.alter("name: string @index(exact) .\nfriend: [uid] .")
    a.mutate(set_nquads='_:a <name> "alice" .\n_:b <name> "bob" .\n'
                        '_:a <friend> _:b .')
    p = str(tmp_path / "p")
    checkpoint.save(a.mvcc.rollup(), p, base_ts=7)
    for name in os.listdir(p):
        raw = open(os.path.join(p, name), "rb").read()
        assert raw[:4] == vault.MAGIC, name
        assert b"alice" not in raw and b"name" not in raw, name
    st, ts = checkpoint.load(p)
    assert ts == 7 and st.n_nodes == 2
    assert_stores_equal(st, ref_ckpt.load(p)[0])
    out = Alpha(base=st, device="cpu", device_threshold=10**9).query(
        '{ q(func: eq(name, "alice")) { friend { name } } }')
    assert out["q"][0]["friend"][0]["name"] == "bob"
    for key in (None, KEY2):
        vault.set_key(key)
        ref_vault.set_key(key)
        with pytest.raises(Exception) as got:
            checkpoint.load(p)
        with pytest.raises(Exception) as want:
            ref_ckpt.load(p)
        assert type(got.value).__name__ == type(want.value).__name__
        assert type(got.value).__name__ in ("VaultError",
                                            "StorageCorruption")


def test_encrypted_wal_replay_and_torn_tail(tmp_path):
    vault.set_key(KEY)
    path = str(tmp_path / "wal.log")
    w = WAL(path, sync=False)
    w.append(Mutation(edge_sets=[(1, "friend", 2, None)],
                      val_sets=[(1, "name", "alice", "", None)]), 5)
    w.append(Mutation(edge_sets=[(2, "friend", 3, None)]), 6)
    w.close()
    raw = open(path, "rb").read()
    assert b"friend" not in raw and b"alice" not in raw
    got = list(replay(path))
    assert [ts for ts, _, _ in got] == [5, 6]
    assert got[0][2].val_sets[0][2] == "alice"
    # the CRC covers ciphertext: the torn tail is cut without the key
    with open(path, "ab") as f:
        f.write(b"DGW1\x99\x00\x00\x00garbage")
    vault.set_key(None)
    end_before = os.path.getsize(path)
    WAL(path, sync=False).close()
    assert os.path.getsize(path) < end_before
    vault.set_key(KEY)
    assert [ts for ts, _, _ in replay(path)] == [5, 6]
    # and the reference reads the port's sealed log
    ref_vault.set_key(KEY)
    from dgraph_tpu.store import wal as ref_wal
    assert [ts for ts, _, _ in ref_wal.replay(path)] == [5, 6]


def test_encrypted_alpha_crash_recovery(tmp_path):
    vault.set_key(KEY)
    p = str(tmp_path / "p")
    a = Alpha.open(p, sync=False, device="cpu")
    a.alter("name: string @index(exact) .")
    a.mutate(set_nquads='_:a <name> "survivor" .')
    a.wal.close()
    a2 = Alpha.open(p, sync=False, device="cpu")
    out = a2.query('{ q(func: eq(name, "survivor")) { name } }')
    assert out["q"][0]["name"] == "survivor"


def test_legacy_no_aad_records_resealed_on_open(tmp_path, monkeypatch):
    import json as _json

    from dgraph_tpu_torch.store import wal as walmod

    vault.set_key(KEY)
    path = str(tmp_path / "j.log")
    with monkeypatch.context() as m:
        m.setattr(walmod, "MAGIC2", walmod.MAGIC)
        m.setattr(walmod, "_rec_aad", lambda seq: b"")
        legacy = walmod.Journal(path, sync=False)
        for i in range(3):
            legacy.append({"i": i})
        legacy.close()
    with open(path, "rb") as f:
        recs = list(walmod._scan(f.read()))
    assert all(leg for _off, _p, leg in recs)
    with pytest.raises(vault.VaultError):
        vault.decrypt(recs[0][1], aad=walmod._rec_aad(0))
    j = walmod.Journal(path, sync=False)
    j.append({"i": 3})
    j.close()
    with open(path, "rb") as f:
        recs = list(walmod._scan(f.read()))
    assert len(recs) == 4
    assert not any(leg for _off, _p, leg in recs)
    for seq, (_off, p, _leg) in enumerate(recs):
        doc = _json.loads(vault.decrypt(p, aad=walmod._rec_aad(seq)))
        assert doc == {"i": seq}
        with pytest.raises(vault.VaultError):
            vault.decrypt(p)
    assert [d["i"] for d in walmod.Journal.replay(path)] == [0, 1, 2, 3]
    before = os.stat(path).st_mtime_ns
    walmod.Journal(path, sync=False).close()
    assert os.stat(path).st_mtime_ns == before


def test_checkpoint_roundtrip_preserves_vec_tablets(tmp_path):
    """`test_vec.py::test_checkpoint_roundtrip_preserves_vec_tablets` on
    the port: float32vector columns persist as dense [k, d] stacks and
    reload to the same tablet, @dim and similar_to answers; the port's
    snapshot loads in the reference to the reference's own store."""
    import test_vec
    from dgraph_tpu.store.checkpoint import load as ref_load
    rng = np.random.default_rng(5)
    b = StoreBuilder(parse_schema(
        "emb: float32vector @dim(%d) .\n"
        "friend: [uid] @reverse .\n"
        "name: string @index(exact) ." % test_vec.DIM))
    for i in range(1, 31):
        b.add_value(i, "emb",
                    [int(x) for x in rng.integers(0, 5, test_vec.DIM)])
        b.add_value(i, "name", f"p{i % 7}")
        for j in rng.integers(1, 31, 3):
            if i != int(j):
                b.add_edge(i, "friend", int(j))
    st = b.finalize()
    assert_stores_equal(st, test_vec._vec_store(n=30, seed=5))
    checkpoint.save(st, str(tmp_path / "p"))
    loaded, _ = checkpoint.load(str(tmp_path / "p"))
    t0, t1 = st.vec_tablet("emb"), loaded.vec_tablet("emb")
    assert t0.subj.tolist() == t1.subj.tolist()
    assert t0.vecs.tobytes() == t1.vecs.tobytes()
    assert loaded.schema.peek("emb").vector_dim == test_vec.DIM
    assert_stores_equal(loaded, ref_load(str(tmp_path / "p"))[0])
    q = ('{ q(func: similar_to(emb, 5, "[1, 2, 0, 2]")) '
         '{ uid friend { uid } } }')
    assert Engine(loaded, device="cpu", device_threshold=10**9).query(q) \
        == Engine(st, device="cpu", device_threshold=10**9).query(q)
