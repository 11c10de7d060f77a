"""The port's ACL against the reference's.

`tests/test_acl.py`'s cases (login and tokens, read and write
enforcement, the HTTP flow, upserts that cannot escalate, userid
injection, `dgraph.type`) run with the port's objects bound in (the
harness of `test_torch_lifecycle.py` with HTTP answers recorded,
`test_torch_http.py`), then with the reference's; the transcripts must
be equal, exactly, but for the fields `test_torch_http.py` names and the
salted password hashes the ACL's own reads return. `test_grpc_gate`
runs over the worker transport in `test_torch_cluster.py`.

The port's own checks:
  * an ACL view reads its snapshot's device caches: after the first
    request no ELL is built, no whole-block program is made and no CSR
    is placed, whichever user asks, and the view holds no cache of its
    own;
  * it never sees a filter set over a predicate it hides: `has(salary)`
    memoized for the snapshot is empty on a view that hides `salary`,
    and answers equal the reference's;
  * a directory with ACL users written by the reference opens in the
    port with the same logins, tokens and permissions, and the other
    way round.
"""

import json
import re

import numpy as np
import pytest

import dgraph_tpu.server.acl as ref_acl
import dgraph_tpu.server.api as ref_api
import test_acl
from dgraph_tpu_torch.engine import fused
from dgraph_tpu_torch.server.acl import READ, WRITE, AclManager, AclView
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_http import PORT, REF, record_http
from test_torch_lifecycle import run_reference_case

# "salt$key", both base64: hash_password's output (salted, so it
# differs between any two runs)
_HASH = re.compile(r"[A-Za-z0-9+/]{22}==\$[A-Za-z0-9+/]{86}==")

CASES = [n for n in dir(test_acl)
         if n.startswith("test_") and n != "test_grpc_gate"]


def _runs(name, tmp_path, monkeypatch):
    out = {}
    for pkg in (PORT, REF):
        log = []
        with monkeypatch.context() as m:
            record_http(m, pkg, log)
            tr = run_reference_case(
                test_acl, name, pkg, tmp_path / pkg, monkeypatch,
                after=lambda tr: [tr.add("http", e) for e in log])
        out[pkg] = [(k, _HASH.sub("<hash>", v)) for k, v in tr]
    return out


@pytest.mark.parametrize("name", CASES)
def test_reference_acl_case_on_port(name, tmp_path, monkeypatch):
    out = _runs(name, tmp_path, monkeypatch)
    assert out[PORT] == out[REF]


def test_case_list_covers_the_module():
    assert len(CASES) == 7


# -- the port's own checks --------------------------------------------------------

SCHEMA = ("name: string @index(exact) .\nsalary: int .\n"
          "friend: [uid] @reverse .")


def _bob(a, acl_mod, perms=READ | WRITE):
    """A `dev` group that may read (and write) name and friend, user bob
    in it (test_acl.py's fixture, with friend edges)."""
    nq = [f'_:g <dgraph.xid> "dev" .', f'_:u <dgraph.xid> "bob" .',
          f'_:u <dgraph.password> "{acl_mod._hash_password("bobpass")}" .',
          '_:u <dgraph.user.group> _:g .']
    for i, p in enumerate(("name", "friend")):
        nq += [f'_:r{i} <dgraph.rule.predicate> "{p}" .',
               f'_:r{i} <dgraph.rule.permission> "{perms}"^^<xs:int> .',
               f'_:g <dgraph.acl.rule> _:r{i} .']
    a.mutate(set_nquads="\n".join(nq))


def _data(n=64, seed=7):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lines.append(f'_:p{i} <name> "p{i}" .')
        if i % 3 == 0:
            lines.append(f'_:p{i} <salary> "{1000 + i}"^^<xs:int> .')
        for j in rng.integers(0, n, 3):
            if int(j) != i:
                lines.append(f"_:p{i} <friend> _:p{int(j)} .")
    return "\n".join(lines)


def _pair(device_threshold=0):
    """The port's and the reference's Alphas over the same ACL'd data."""
    pa = Alpha(device="cpu", device_threshold=device_threshold)
    ra = ref_api.Alpha(device_threshold=10**9)
    for a, mgr, mod in ((pa, AclManager, None), (ra, ref_acl.AclManager,
                                                  ref_acl)):
        a.acl = mgr(a, "secret")
        a.acl.ensure_groot()
        a.alter(SCHEMA)
        a.mutate(set_nquads=_data())
        _bob(a, mod or __import__("dgraph_tpu_torch.server.acl",
                                  fromlist=["_hash_password"]))
    return pa, ra


QUERIES = [
    '{ q(func: eq(name, "p%d")) { name salary friend { name salary '
    'friend { name } } } }' % i for i in range(0, 12, 3)] + [
    '{ q(func: has(name), first: 6) { name friend @filter(has(salary)) '
    '{ name salary } } }',
    '{ q(func: has(salary)) { name } }',
]
BATCH = ["{ q(func: eq(name, \"p%d\")) @recurse(depth: 3) { friend uid } }"
         % i for i in range(8)] + [
    '{ q(func: eq(name, "p%d")) { name friend { name friend { name } } } }'
    % i for i in range(8)]


def test_acl_view_shares_the_snapshot_caches():
    """After the first ACL'd request, no ELL is built, no program made,
    no CSR placed: the view reads the snapshot's; a guardian and a
    restricted user share them too."""
    pa, _ra = _pair()
    fused.reset()
    pa.query_batch(BATCH, acl_user="bob")
    for q in QUERIES:
        pa.query(q, acl_user="bob")
    store = pa.mvcc.read_view(pa.oracle.read_only_ts())
    builds0 = METRICS.get("plan_cache_misses_total", cache="batch")
    ell0 = dict(store.__dict__.get("_ell_cache", {}))
    dev0 = set(store._device)
    trees0 = dict(store.__dict__.get("_tree_fns", {}))
    st0 = fused.status()
    assert ell0 and dev0 and trees0 and st0["programs"]
    views = []
    orig = AclView.__init__

    def spy(self, *x, **k):
        orig(self, *x, **k)
        views.append(self)

    AclView.__init__ = spy
    try:
        for _ in range(3):
            out_b = pa.query_batch(BATCH, acl_user="bob")
            outs = [pa.query(q, acl_user="bob") for q in QUERIES]
    finally:
        AclView.__init__ = orig
    assert views and all(v._ell_host is store for v in views)
    assert store.__dict__["_ell_cache"] == ell0
    assert set(store._device) == dev0
    assert store.__dict__["_tree_fns"] == trees0
    st = fused.status()
    assert st["programs"] == st0["programs"]
    assert st["misses"] == st0["misses"] and st["hits"] > st0["hits"]
    assert METRICS.get("plan_cache_misses_total", cache="batch") == builds0
    for v in views:       # the view keeps no cache of its own
        assert not {"_ell_cache", "_ell_devs", "_ell_fns",
                    "_tree_fns"} & set(v.__dict__)
        assert v._device == {} and v._vec_dev == {}
    # nothing the restricted user may not read
    assert "salary" not in json.dumps(outs) + json.dumps(out_b)
    # the guardian's requests run on the snapshot itself: same programs
    pa.query_batch(BATCH, acl_user="groot")
    assert fused.status()["programs"] == st0["programs"]


def test_acl_answers_equal_the_reference_and_hide_what_they_must():
    pa, ra = _pair()
    for user in ("bob", "groot"):
        for q in QUERIES:
            assert pa.query(q, acl_user=user) == ra.query(q, acl_user=user)
        assert pa.query_batch(BATCH, acl_user=user) == \
            ra.query_batch(BATCH, acl_user=user)
    assert pa.query('{ q(func: has(salary)) { name } }',
                    acl_user="bob") == {"q": []}


def test_view_never_reads_a_filter_set_over_a_hidden_predicate():
    """has(salary) memoized on the snapshot (a guardian's request) must
    not answer a view that hides salary, and the view's own memo entry
    must not answer the guardian."""
    pa, ra = _pair()
    q = ('{ q(func: has(name), first: 10) { name friend @filter('
         'has(salary)) { name } } }')
    store = pa.mvcc.read_view(pa.oracle.read_only_ts())
    g1 = pa.query(q, acl_user="groot")
    assert any(r.get("friend") for r in g1["q"])
    assert store._filter_sets      # memoized for the snapshot
    b1 = pa.query(q, acl_user="bob")
    assert not any(r.get("friend") for r in b1["q"])
    assert pa.query(q, acl_user="groot") == g1
    assert pa.query(q, acl_user="bob") == b1
    assert b1 == ra.query(q, acl_user="bob")
    assert g1 == ra.query(q, acl_user="groot")
    assert any(k[0][0] == "acl" for k in store._filter_sets
               if isinstance(k, tuple) and isinstance(k[0], tuple))


@pytest.mark.parametrize("writer", [PORT, REF])
def test_acl_directory_crosses_packages(writer, tmp_path):
    """Users, groups and rules written through one package's Alpha and
    checkpoint log in through the other's with the same permissions,
    and a token one issues the other verifies (same secret)."""
    p = str(tmp_path / "p")
    w_alpha = (Alpha.open(p, device="cpu") if writer == PORT
               else ref_api.Alpha.open(p))
    w_mod = (__import__("dgraph_tpu_torch.server.acl",
                        fromlist=["AclManager"]) if writer == PORT
             else ref_acl)
    w_alpha.acl = w_mod.AclManager(w_alpha, "secret")
    w_alpha.acl.ensure_groot()
    w_alpha.alter(SCHEMA)
    w_alpha.mutate(set_nquads=_data(24))
    _bob(w_alpha, w_mod, perms=READ)
    tok = w_alpha.acl.login("bob", "bobpass")
    w_alpha.checkpoint_to(p)
    w_alpha.wal.close()
    r_alpha = (ref_api.Alpha.open(p) if writer == PORT
               else Alpha.open(p, device="cpu"))
    r_mod = ref_acl if writer == PORT else __import__(
        "dgraph_tpu_torch.server.acl", fromlist=["AclManager"])
    r_alpha.acl = r_mod.AclManager(r_alpha, "secret")
    r_alpha.acl.ensure_groot()          # already there: a no-op
    assert r_alpha.acl.verify(tok) == "bob"
    assert r_alpha.acl.verify(r_alpha.acl.login("bob", "bobpass")) == "bob"
    with pytest.raises(PermissionError):
        r_alpha.acl.login("bob", "wrong")
    assert r_alpha.acl.perms_for("bob") == w_alpha.acl.perms_for("bob")
    assert r_alpha.acl.perms_for("groot")[0] is True
    for q in QUERIES:
        assert r_alpha.query(q, acl_user="bob") == \
            w_alpha.query(q, acl_user="bob")
    with pytest.raises(PermissionError):
        r_alpha.mutate(set_nquads='_:x <name> "nope" .', acl_user="bob")
    r_alpha.wal.close()
