"""The port's backup, verify and restore against the reference's.

`tests/test_backup.py`'s cases, `test_vault.py::
test_encrypted_backup_restore` and `test_txn.py::
test_drop_attr_in_backup_chain` run with the port's objects (the harness
of `test_torch_lifecycle.py`) and again with the reference's; their
transcripts (query answers, mutation results, backup manifests, restore
timestamps, verify reports) must be equal. A chain written by either
package restores on the other to the same Store, array for array, in
the same files. Tolerance: exact.
"""

import os

import pytest

import dgraph_tpu.native as ref_native
import dgraph_tpu.server.api as ref_api
import dgraph_tpu.server.backup as ref_backup
import dgraph_tpu.store.checkpoint as ref_checkpoint
import dgraph_tpu.store.vault as ref_vault
import test_backup
import test_txn
import test_vault
from dgraph_tpu_torch import native
from dgraph_tpu_torch.server import backup
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store import checkpoint, vault
from test_torch_lifecycle import compare_case, reference_cases
from test_torch_mvcc import assert_stores_equal

# the cases that run the CLI run in test_torch_cli.py
CASES = ([(test_backup, n) for n in reference_cases(test_backup)]
         + [(test_vault, "test_encrypted_backup_restore"),
            (test_txn, "test_drop_attr_in_backup_chain")])


@pytest.fixture(autouse=True)
def _no_key():
    vault.set_key(None)
    ref_vault.set_key(None)
    yield
    vault.set_key(None)
    ref_vault.set_key(None)
    vault.set_io_fault(None)
    ref_vault.set_io_fault(None)


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_reference_case_on_port(module, name, tmp_path, monkeypatch):
    try:
        compare_case(module, name, tmp_path, monkeypatch)
    finally:
        vault.set_key(None)
        ref_vault.set_key(None)


def test_case_list_covers_the_issue():
    names = {n for _m, n in CASES}
    assert len([n for m, n in CASES if m is test_backup]) == 13
    assert {"test_full_then_incremental_roundtrip",
            "test_corrupt_sidecars_never_abort_open",
            "test_restore_kill_at_any_point_resumes_bit_identical",
            "test_verify_chain_clean_and_corrupt",
            "test_encrypted_backup_restore",
            "test_drop_attr_in_backup_chain"} <= names


# -- chains cross between the packages -------------------------------------------

SCHEMA = ("name: string @index(exact) .\nage: int @index(int) .\n"
          "friend: [uid] @reverse .\nnick: string @lang .")


def _write_chain(alpha_open, do_backup, p, dest):
    """A full backup (after a drop_attr and a rebirth), then writes
    (facets, langs, deletes) and an incremental one."""
    a = alpha_open(p)
    a.alter(SCHEMA)
    a.mutate(set_nquads="\n".join(
        f'_:u{i} <name> "user-{i}" .\n_:u{i} <age> "{20 + i}"^^<xs:int> .\n'
        f'_:u{i} <nick> "n{i}"@en .\n_:u{i} <friend> _:u{(i + 1) % 6} '
        f'(since={2000 + i}) .' for i in range(6)))
    a.drop_attr("nick")
    a.mutate(set_nquads='<0x3> <nick> "reborn"@en .')
    a.checkpoint_to(p)
    a.wal.close()
    m1 = do_backup(p, dest)
    a = alpha_open(p)
    a.mutate(set_nquads='_:x <name> "late" (src="web") .\n'
                        '_:x <nick> "tard"@fr .\n_:x <friend> <0x1> .')
    a.mutate(del_nquads='<0x2> <age> * .\n<0x4> <friend> <0x5> .')
    a.wal.close()
    m2 = do_backup(p, dest)
    assert (m1["type"], m2["type"]) == ("full", "incr")
    return m1, m2


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


# The uid block's codec follows each package's `native.HAVE_NATIVE`: the
# reference's library is built only by `make -C dgraph_tpu/native`, the
# port's at first use. A byte comparison holds both packages to one
# codec: the reference's own switch, and the other codec as well, which
# needs the reference's library when that codec is the compressed one.
CHAIN_CASES = [(w, other) for other in (False, True)
               for w in ("reference", "port")]


def _one_codec(monkeypatch, other: bool):
    on = ref_native.HAVE_NATIVE != other
    if on and not ref_native.HAVE_NATIVE:
        pytest.skip("the reference's native codec library is not built")
    monkeypatch.setattr(native, "HAVE_NATIVE", on)
    monkeypatch.setattr(ref_native, "HAVE_NATIVE", on)


@pytest.mark.parametrize(
    "writer,other", CHAIN_CASES,
    ids=[f"{w}-other-codec" if o else w for w, o in CHAIN_CASES])
def test_chain_crosses_packages(writer, other, tmp_path, monkeypatch):
    """A chain written by `writer` restores on both packages to equal
    stores (array for array) and byte-identical checkpoint files, both
    packages under one uid codec: the reference's own, or the other."""
    _one_codec(monkeypatch, other)
    p, dest = str(tmp_path / "p"), str(tmp_path / "bk")
    if writer == "reference":
        _write_chain(lambda d: ref_api.Alpha.open(d, sync=False),
                     ref_backup.backup, p, dest)
    else:
        _write_chain(lambda d: Alpha.open(d, sync=False, device="cpu"),
                     backup.backup, p, dest)
    assert backup.verify_chain(dest)["ok"]
    assert ref_backup.verify_chain(dest)["ok"]
    r_port, r_ref = str(tmp_path / "r_port"), str(tmp_path / "r_ref")
    ts_port = backup.restore(dest, r_port)
    ts_ref = ref_backup.restore(dest, r_ref)
    assert ts_port == ts_ref
    got, got_ts = checkpoint.load(r_port)
    want, want_ts = ref_checkpoint.load(r_ref)
    assert got_ts == want_ts
    assert_stores_equal(got, want)
    d_port, d_ref = checkpoint.resolve(r_port), ref_checkpoint.resolve(r_ref)
    assert os.path.basename(d_port) == os.path.basename(d_ref)
    assert _files(d_port) == _files(d_ref)
    q = ('{ q(func: has(name)) { name age nick@en nick@fr '
         'friend @facets { name } ~friend { name } } }')
    assert Alpha.open(r_port, device="cpu").query(q) == \
        ref_api.Alpha.open(r_ref).query(q)


def test_restore_resumes_from_a_reference_journal(tmp_path):
    """A restore the reference began (killed after some tablets) is
    resumed by the port's restore: the journals and staging layout are
    one format."""

    class Kill(Exception):
        pass

    p, dest = str(tmp_path / "p"), str(tmp_path / "bk")
    _write_chain(lambda d: ref_api.Alpha.open(d, sync=False),
                 ref_backup.backup, p, dest)
    clean = str(tmp_path / "clean")
    ref_backup.restore(dest, clean)
    tgt = str(tmp_path / "tgt")
    seen = [0]

    def hook(path, data):
        seen[0] += 1
        if seen[0] == 6:
            raise Kill(path)
        return data

    ref_vault.set_io_fault(hook)
    try:
        with pytest.raises(Kill):
            ref_backup.restore(dest, tgt)
    finally:
        ref_vault.set_io_fault(None)
    assert os.path.exists(os.path.join(tgt, "restore.journal"))
    backup.restore(dest, tgt)
    assert not os.path.exists(os.path.join(tgt, "restore.journal"))
    assert _files(checkpoint.resolve(tgt)) == \
        _files(ref_checkpoint.resolve(clean))


def _killed_restore(dest, tgt, kill_at):
    """A port restore into `tgt` killed at its `kill_at`-th file write:
    its journal and staged files stay behind."""

    class Kill(Exception):
        pass

    seen = [0]

    def hook(path, data):
        seen[0] += 1
        if seen[0] == kill_at:
            raise Kill(path)
        return data

    vault.set_io_fault(hook)
    try:
        with pytest.raises(Kill):
            backup.restore(dest, tgt)
    finally:
        vault.set_io_fault(None)
    assert os.path.exists(os.path.join(tgt, "restore.journal"))


@pytest.mark.parametrize("first", [True, False], ids=["codec-then-plain",
                                                      "plain-then-codec"])
def test_restore_resumes_across_codecs(first, tmp_path, monkeypatch):
    """A port restore killed under one uid codec and resumed by a
    process with the other finishes, equal byte for byte to a clean
    restore under the first run's codec: the resumed run keeps the
    codec of the uid block its first run staged."""
    if not native.built():
        pytest.skip("the port's native codec library did not build")
    p, dest = str(tmp_path / "p"), str(tmp_path / "bk")
    monkeypatch.setattr(native, "HAVE_NATIVE", first)
    _write_chain(lambda d: Alpha.open(d, sync=False, device="cpu"),
                 backup.backup, p, dest)
    clean = str(tmp_path / "clean")
    backup.restore(dest, clean)
    tgt = str(tmp_path / "tgt")
    _killed_restore(dest, tgt, kill_at=4)
    monkeypatch.setattr(native, "HAVE_NATIVE", not first)
    backup.restore(dest, tgt)
    assert not os.path.exists(os.path.join(tgt, "restore.journal"))
    assert _files(checkpoint.resolve(tgt)) == \
        _files(checkpoint.resolve(clean))
    uids = "uids.duc" if first else "uids.npy"
    assert uids in os.listdir(checkpoint.resolve(tgt))
