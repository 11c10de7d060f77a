"""The port's cluster against the reference's: Zero, groups of Alphas
over loopback gRPC, routed reads, replicated commits.

The reference's own cluster cases (`test_cluster.py`, and the gRPC cases
of `test_server.py`, `test_acl.py`, `test_admission.py`,
`test_mvcc_retention.py`, `test_txn.py` and `test_outofcore.py`) run
twice through the harness of `test_torch_lifecycle.py`: once with every
`dgraph_tpu.*` name bound to the port's counterpart, the port's Alphas on
the CPU (`start_cluster_alpha(..., device="cpu")`), and once with the
reference's own objects. Each run's transcript holds every Alpha call's
result, those of the Alphas `start_cluster_alpha` boots included; the
two must be equal, exactly, but for the fields that carry a port, a
trace or span id, a latency or a salted password hash (`normalise`). A
case whose answers turn on the wall clock keeps only its own assertions
(`compare_cluster_case(..., nondeterministic=True)`).
`compare_cluster_case` is the harness the other cluster files
(`test_torch_{quorum,zero,resilience,fleet}.py`) share.

The port's own checks, each with its reason:
  * one wire: a port Alpha joins a reference Zero and serves a reference
    Alpha's ServeTask and TabletSnapshot, and the reverse, answering as
    an all-port and an all-reference cluster do (the port's protos hold
    the reference's bytes);
  * tablets cross: a tablet packed by either package unpacks in the
    other into equal arrays;
  * WALs cross: a port replica's WAL with `pend` and `decision` records
    replays in the reference into the same folded store, and the reverse;
  * no capture over a routed view: programs captured 0, fallbacks 0;
  * pulled tablets keep their caches: a second request at the same
    version builds no ELL and places nothing, a new version builds
    again, evicting `api.tablet` drops the device copies;
  * no RPC under a process-wide lock: three nodes in one process, 8
    threads of crossing queries, a deadline on every call, none runs out.
"""

import functools
import re
import threading

import numpy as np
import pytest

import dgraph_tpu.cluster as ref_cluster
import dgraph_tpu.cluster.tablet as ref_tablet
import dgraph_tpu.cluster.zero as ref_zero
import dgraph_tpu.server.api as ref_api
import dgraph_tpu.store.store as ref_store
import dgraph_tpu_torch.cluster as port_cluster
import dgraph_tpu_torch.cluster.tablet as port_tablet
import dgraph_tpu_torch.cluster.zero as port_zero
import dgraph_tpu_torch.server.api as port_api
import dgraph_tpu_torch.store.store as port_store
import test_acl
import test_admission
import test_cluster
import test_mvcc_retention
import test_outofcore
import test_server
import test_txn
from dgraph_tpu_torch.engine import fused
from dgraph_tpu_torch.utils import memgov
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_lifecycle import (PORT, REF, _recording_alpha,
                                  reference_cases, run_reference_case)
from test_torch_mvcc import assert_stores_equal

# -- the harness ---------------------------------------------------------------

_ADDR = re.compile(r"127\.0\.0\.1:\d+|localhost:\d+|\[::1?\]:\d+")
_IDS = re.compile(r'("(?:trace_id|span_id|parent_id)": *)"?[0-9a-fx]+"?')
_CLOCKS = re.compile(r'("[a-z_]*(?:_us|_ms|_s|latency[a-z_]*)": *)'
                     r'[-0-9.e]+')
_UID = re.compile(r'"0x[0-9a-f]+"')
# a salted password hash ("salt$key", both base64) differs between runs
_HASH = re.compile(r"[A-Za-z0-9+/]{22}==\$[A-Za-z0-9+/]{86}==")


def normalise(text: str) -> str:
    """A transcript entry with its ports, trace and span ids and clock
    fields written as placeholders (and a salted password hash, which
    the ACL's own reads return)."""
    text = _HASH.sub("<hash>", _ADDR.sub("<addr>", text))
    text = _IDS.sub(r"\1<id>", text)
    return _CLOCKS.sub(r"\1<t>", text)


def cluster_extra(pkg, tr):
    """`start_cluster_alpha` for one run: the package's own, its Alphas
    recorded in the transcript; the port's on the CPU."""
    real = (port_cluster if pkg == PORT else ref_cluster).start_cluster_alpha
    recs = {}

    @functools.wraps(real)
    def start(*a, **kw):
        if pkg == PORT:
            kw.setdefault("device", "cpu")
        alpha, server, addr = real(*a, **kw)
        cls = type(alpha)
        if any(c.__module__ == _recording_alpha.__module__
               for c in cls.__mro__):
            return alpha, server, addr   # the run's Alpha already records
        if cls not in recs:
            recs[cls] = _recording_alpha(cls, tr, cpu=False)
        alpha.__class__ = recs[cls]
        return alpha, server, addr

    return {"dgraph_tpu.cluster": {"start_cluster_alpha": start}}


def compare_cluster_case(module, name, tmp_path, monkeypatch,
                         nondeterministic=False, factory=None, polls=False,
                         port_ordered=False):
    """Both runs of one reference case; their transcripts must be equal
    (after `normalise`) unless the case is nondeterministic. `polls`:
    the case polls a condition on the clock, reading the same answer
    until it holds, so a run of equal entries counts once.
    `port_ordered`: the case picks its nodes by the sort order of their
    ephemeral ports, which decides which node's uid lease a new uid
    comes from, so uids are written as placeholders."""
    logs = {}
    for pkg in (PORT, REF):
        log = run_reference_case(module, name, pkg, tmp_path / pkg,
                                 monkeypatch, factory=factory,
                                 extra=cluster_extra)
        logs[pkg] = [(k, normalise(v)) for k, v in log]
        if port_ordered:
            logs[pkg] = [(k, _UID.sub('"<uid>"', v)) for k, v in logs[pkg]]
        if polls:
            logs[pkg] = [e for i, e in enumerate(logs[pkg])
                         if i == 0 or e != logs[pkg][i - 1]]
    if not nondeterministic:
        assert logs[PORT] == logs[REF]
    return logs[PORT]


# -- test_cluster.py on the port ---------------------------------------------------

# the CLI's case waits for ROADMAP Queue 1 item 9f
CLUSTER_CASES = reference_cases(
    test_cluster, skip={"test_two_process_cluster_via_cli"})


@pytest.mark.parametrize("name", CLUSTER_CASES)
def test_cluster_case_on_port(name, tmp_path, monkeypatch):
    compare_cluster_case(test_cluster, name, tmp_path, monkeypatch)


# -- the gRPC seam's cases in the single-node files --------------------------------

SEAM_CASES = [
    (test_server, "test_grpc_query_mutate_alter"),
    (test_server, "test_grpc_serve_task_seam"),
    (test_acl, "test_grpc_gate"),
    (test_admission, "test_grpc_budget_forwarding_deadline"),
    (test_admission, "test_peer_spans_reachable_over_worker_transport"),
    (test_mvcc_retention, "test_grpc_txn_continuation"),
    (test_txn, "test_serve_task_read_leaves_no_pending_txn"),
    (test_txn, "test_drop_attr_with_out_of_order_later_commit"),
    (test_outofcore, "test_corrupt_tablet_typed_refusal_then_replica_heal"),
    (test_outofcore, "test_clustered_heal_pulls_real_tablet_snapshot"),
]


@pytest.mark.parametrize("module,name", SEAM_CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in SEAM_CASES])
def test_grpc_seam_case_on_port(module, name, tmp_path, monkeypatch,
                                tmp_path_factory):
    compare_cluster_case(module, name, tmp_path, monkeypatch,
                         factory=tmp_path_factory)


# -- the port's own checks ---------------------------------------------------------


_ZERO = {PORT: port_zero, REF: ref_zero}
_START = {PORT: functools.partial(port_cluster.start_cluster_alpha,
                                  device="cpu"),
          REF: ref_cluster.start_cluster_alpha}
SCHEMA = test_cluster.SCHEMA
WIRE_QS = [test_cluster.SPAN_Q,
           '{ q(func: eq(name, "carol")) { name ~friend { name } } }',
           '{ q(func: has(friend)) { name friend { name age } } }',
           '{ q(func: eq(name, "alice")) @recurse(depth: 3) '
           '{ name friend } }']


def _two_groups(zero_pkg, g1_pkg, g2_pkg, **kw):
    """Zero + two single-node groups of the given packages: `name`,
    `age` and `dgraph.type` on group 1, `friend` on group 2, loaded
    through group 1's coordinator."""
    zmod = _ZERO[zero_pkg]
    zs, zport, _st = zmod.make_zero_server()
    zs.start()
    zt = f"127.0.0.1:{zport}"
    kw.setdefault("device_threshold", 10**9)
    a1, s1, _ = _START[g1_pkg](zt, **kw)
    a2, s2, _ = _START[g2_pkg](zt, **kw)
    zc = zmod.ZeroClient(zt)
    for pred in ("name", "age", "dgraph.type"):
        zc.should_serve(pred, a1.groups.gid)
    zc.should_serve("friend", a2.groups.gid)
    a1.alter(SCHEMA)
    a1.groups.refresh()
    a2.groups.refresh()
    test_cluster.load_fixture(a1)
    return a1, a2, (s1, s2, zs)


def _wire_answers(zero_pkg, g1_pkg, g2_pkg):
    a1, a2, servers = _two_groups(zero_pkg, g1_pkg, g2_pkg)
    try:
        out = []
        a2.mutate(set_nquads='_:d <name> "dave" .\n'
                             '_:d <friend> <0x1> .')
        for hop_max in (4096, 0):    # ServeTask legs, then tablet pulls
            for a in (a1, a2):
                a.remote_hop_max = hop_max
                a._tablet_cache.clear()
                out += [a.query(q) for q in WIRE_QS]
        return out
    finally:
        for s in servers:
            s.stop(None)


@pytest.mark.parametrize("pkgs", [(REF, PORT, REF), (PORT, REF, PORT),
                                  (REF, REF, PORT), (PORT, PORT, REF)],
                         ids=lambda p: "zero-%s_g1-%s_g2-%s" % p)
def test_one_wire_mixed_clusters_answer_as_one_package(pkgs):
    """A port Alpha joins a reference Zero and serves a reference
    Alpha's ServeTask and TabletSnapshot (and the reverse): the mixed
    cluster answers, per hop and per pulled tablet, as an all-port and
    an all-reference one. The method paths and the messages' bytes are
    the reference's."""
    want = _wire_answers(REF, REF, REF)
    assert _wire_answers(PORT, PORT, PORT) == want
    assert _wire_answers(*pkgs) == want


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_tablets_cross_between_packages(direction):
    """A tablet packed by either package unpacks in the other into
    arrays equal to the other's own."""
    from dgraph_tpu_torch.store.schema import parse_schema as port_schema
    from dgraph_tpu.store.schema import parse_schema as ref_schema
    text = ("name: string @index(exact, term) @lang .\n"
            "age: int @index(int) .\nfriend: [uid] @reverse @count .")
    stores = {}
    for key, smod, schema in ((PORT, port_store, port_schema(text)),
                              (REF, ref_store, ref_schema(text))):
        b = smod.StoreBuilder(schema)
        rng = np.random.default_rng(7)
        for i in range(1, 41):
            b.add_value(i, "name", f"p{i} x{i % 3}")
            b.add_value(i, "name", f"q{i}", lang="fr")
            b.add_value(i, "age", int(rng.integers(18, 60)),
                        facets={"since": int(i)})
        for s, o in rng.integers(1, 41, (120, 2)).tolist():
            b.add_edge(s, "friend", o, facets={"w": float(s + o) / 2})
        stores[key] = b.finalize()
    src, dst = (PORT, REF) if direction == "port_to_ref" else (REF, PORT)
    pack = (port_tablet if src == PORT else ref_tablet).pack_tablet
    unpack = (port_tablet if dst == PORT else ref_tablet).unpack_tablet
    sdst = stores[dst]
    preds = {p: unpack(pack(stores[src].preds[p]), p, sdst.schema)
             for p in stores[src].preds}
    got = (port_store if dst == PORT else ref_store).Store(
        sdst.uids, sdst.schema, preds)
    if dst == PORT:
        assert_stores_equal(got, stores[REF])
    else:
        assert_stores_equal(stores[PORT], got)


def _replica_wals(pkg, tmp_path):
    """A three-replica group of `pkg` with WALs: mutations, an Alter and
    a DropAttr committed through the quorum (pend and decision records),
    one commit refused for want of a majority (an abort decision).
    Returns (replica WAL paths, each replica's folded store)."""
    zmod = _ZERO[pkg]
    zs, zport, _st = zmod.make_zero_server(zmod.ZeroState(replicas=3))
    zs.start()
    zt = f"127.0.0.1:{zport}"
    nodes = []
    for i in range(3):
        d = tmp_path / pkg / f"n{i}"
        d.mkdir(parents=True)
        nodes.append(_START[pkg](zt, device_threshold=10**9,
                                 wal_dir=str(d)))
    a0 = nodes[0][0]
    zc = zmod.ZeroClient(zt)
    for pred in ("name", "age", "friend", "dgraph.type"):
        zc.should_serve(pred, a0.groups.gid)
    a0.alter(SCHEMA)
    for a, _s, _addr in nodes:
        a.groups.refresh()
    test_cluster.load_fixture(a0)
    nodes[1][0].mutate(set_nquads='_:d <name> "dave" .\n'
                                  '_:d <age> "40"^^<xs:int> .\n'
                                  '_:d <friend> <0x1> .')
    nodes[2][0].mutate(del_nquads='<0x2> <age> * .')
    a0.drop_attr("age")
    a0.alter("age: int @index(int) .")
    nodes[1][0].mutate(set_nquads='<0x3> <age> "51"^^<xs:int> .')
    paths = [a.wal.path for a, _s, _addr in nodes]
    folded = [a.mvcc.rollup() for a, _s, _addr in nodes]
    for _a, s, _addr in nodes:
        s.stop(None)
    zs.stop(None)
    for a, _s, _addr in nodes:
        a.wal.close()
    return paths, folded


@pytest.mark.parametrize("writer", [PORT, REF])
def test_wals_cross_with_pend_and_decision_records(writer, tmp_path):
    """Each replica's WAL (pend, decision, schema and drop records the
    commit quorum writes) replays in the other package into the same
    folded store as the replica itself holds."""
    from dgraph_tpu_torch.store.wal import replay
    paths, folded = _replica_wals(writer, tmp_path)
    kinds = {k for p in paths for _ts, k, _o in replay(p)}
    assert {"pend", "dec", "schema", "drop_attr"} <= kinds
    for path, store in zip(paths, folded):
        if writer == PORT:
            a = ref_api.Alpha(device_threshold=10**9)
            a.attach_wal(path, sync=False)
            assert_stores_equal(store, a.mvcc.rollup())
        else:
            a = port_api.Alpha(device_threshold=10**9, device="cpu")
            a.attach_wal(path, sync=False)
            assert_stores_equal(a.mvcc.rollup(), store)
        a.wal.close()


# four of each lane family (engine/batch.py MIN_BATCH): recurse over
# both directions of the foreign tablet, the level tree, shortest paths
_WHO = ("alice", "bob", "carol", "alice")
BATCH = ([f'{{ q(func: eq(name, "{w}")) @recurse(depth: 3) {{ uid friend }} }}'
          for w in _WHO]
         + [f'{{ q(func: eq(name, "{w}")) @recurse(depth: 2) '
            f'{{ uid ~friend }} }}' for w in _WHO]
         + [f'{{ q(func: eq(name, "{w}")) {{ name friend {{ name friend '
            f'{{ name }} }} }} }}' for w in _WHO]
         + [f'{{ path as shortest(from: {f}, to: {t}) {{ friend }} '
            f'p(func: uid(path)) {{ name }} }}'
            for f, t in (("0x1", "0x3"), ("0x1", "0x2"), ("0x2", "0x3"),
                         ("0x1", "0x3"))])


def _host_of(alpha, pred):
    hosts = [e[-1] for k, e in alpha._tablet_cache.items() if k[0] == pred]
    assert len(hosts) == 1, alpha._tablet_cache.keys()
    return hosts[0]


def test_routed_view_captures_no_program(monkeypatch):
    """A routed view runs the staged route, counted as `staged`: no
    whole-block program is made over it (its relations would fault
    foreign tablets over the wire inside the capture) and nothing falls
    back."""
    monkeypatch.setenv("DGRAPH_TPU_FUSED", "1")
    a1, a2, servers = _two_groups(PORT, PORT, PORT)
    try:
        fused.reset()
        fb0 = METRICS.get("fused_route_total", route="fallback")
        st0 = METRICS.get("fused_route_total", route="staged")
        want = [a.query(q) for a in (a1, a2) for q in WIRE_QS]
        st = fused.status()
        assert st["programs"] == 0 and st["misses"] == 0
        assert st["routes"].get("fused", 0) == 0
        assert st["routes"].get("fallback", 0) == 0
        assert METRICS.get("fused_route_total", route="fallback") == fb0
        assert METRICS.get("fused_route_total", route="staged") > st0
    finally:
        for s in servers:
            s.stop(None)
    r1, r2, servers = _two_groups(REF, REF, REF)
    try:
        assert want == [a.query(q) for a in (r1, r2) for q in WIRE_QS]
    finally:
        for s in servers:
            s.stop(None)


def test_pulled_tablets_keep_their_caches():
    """A pulled tablet's ELL blocks, device copies and runners live on
    its host beside the tablet cache's entry: a second request at the
    same version builds no ELL, places nothing and pulls nothing; a new
    version builds again; evicting the `api.tablet` entry drops the
    device copies and the runners."""
    a1, a2, servers = _two_groups(PORT, PORT, PORT, device_threshold=0)
    try:
        a1.remote_hop_max = 0            # whole-tablet pulls only
        want = a1.query_batch(BATCH)
        singles = [a1.query(q) for q in BATCH]
        host = _host_of(a1, "friend")
        ell0 = dict(host.__dict__["_ell_cache"])
        dev0 = dict(host._device)
        fns0 = dict(host.__dict__.get("_ell_fns", {}))
        pulled0 = METRICS.get("tablet_bytes_fetched")
        assert ell0 and dev0
        for _ in range(2):
            assert a1.query_batch(BATCH) == want
            assert [a1.query(q) for q in BATCH] == singles
        assert _host_of(a1, "friend") is host
        assert host.__dict__["_ell_cache"] == ell0
        assert all(host._device[k] is v for k, v in dev0.items())
        assert all(host.__dict__["_ell_fns"][k] is v
                   for k, v in fns0.items())
        assert METRICS.get("tablet_bytes_fetched") == pulled0
        # a new version of the tablet is pulled and built again
        a2.mutate(set_nquads='<0x3> <friend> <0x1> .')
        out = a1.query_batch(BATCH)
        assert out != want
        new = _host_of(a1, "friend")
        assert new is not host and new.__dict__["_ell_cache"]
        assert METRICS.get("tablet_bytes_fetched") > pulled0
        # evicting the api.tablet entry drops its host's device copies
        entry = [e for e in memgov.GOVERNOR._snapshot("host")
                 if e.name == "api.tablet" and e.owner_ref() is a1]
        assert len(entry) == 1
        while a1._tablet_cache:
            assert entry[0].evict_one_cb() > 0
        assert new._device == {} and not new.__dict__["_ell_devs"]
        assert not new.__dict__.get("_ell_fns")
        assert a1.query_batch(BATCH) == out
    finally:
        for s in servers:
            s.stop(None)


def test_no_rpc_under_a_process_wide_lock():
    """Three single-node groups in one process, 8 threads of queries
    that cross all three from every coordinator, each with a deadline:
    every call answers as the same query alone does, and none runs out
    of its budget (a lock held across an RPC whose handler, in this
    process, needs it would deadlock until the deadline)."""
    zs, zport, _st = port_zero.make_zero_server()
    zs.start()
    zt = f"127.0.0.1:{zport}"
    nodes = [port_cluster.start_cluster_alpha(zt, device_threshold=0,
                                              device="cpu")
             for _ in range(3)]
    alphas = [a for a, _s, _addr in nodes]
    zc = port_zero.ZeroClient(zt)
    for pred, i in (("name", 0), ("dgraph.type", 0), ("friend", 1),
                    ("follows", 2)):
        zc.should_serve(pred, alphas[i].groups.gid)
    alphas[0].alter("name: string @index(exact) .\n"
                    "friend: [uid] @reverse .\nfollows: [uid] .")
    for a in alphas:
        a.groups.refresh()
    rng = np.random.default_rng(3)
    rdf = [f'<{hex(i)}> <name> "n{i}" .' for i in range(1, 201)]
    rdf += [f'<{hex(s)}> <friend> <{hex(o)}> .'
            for s, o in rng.integers(1, 201, (600, 2)).tolist()]
    rdf += [f'<{hex(s)}> <follows> <{hex(o)}> .'
            for s, o in rng.integers(1, 201, (600, 2)).tolist()]
    alphas[1].mutate(set_nquads="\n".join(rdf))
    qs = [f'{{ q(func: eq(name, "n{i}")) {{ name friend {{ follows '
          f'{{ name ~friend {{ uid }} }} }} }} }}' for i in (1, 7, 42)]
    qs += [f'{{ q(func: eq(name, "n{i}")) @recurse(depth: 3) '
           f'{{ uid follows friend }} }}' for i in (3, 9)]
    want = [alphas[0].query(q) for q in qs]
    errors, done = [], []

    def worker(k):
        try:
            for j in range(6):
                a = alphas[(k + j) % 3]
                a.remote_hop_max = 4096 if (k + j) % 2 else 0
                if j % 3 == 2:
                    got = a.query_batch(qs, deadline_ms=60_000)
                    assert got == want
                else:
                    q = (k + j) % len(qs)
                    assert a.query(qs[q], deadline_ms=60_000) == want[q]
            done.append(k)
        except Exception as e:  # noqa: BLE001 — a deadline among them
            errors.append((k, repr(e)))

    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a call hung"
        assert errors == [] and sorted(done) == list(range(8))
    finally:
        for _a, s, _addr in nodes:
            s.stop(None)
        zs.stop(None)


def test_pulled_tablet_beyond_grpc_default_message_limit():
    """A whole-tablet pull past gRPC's 4 MiB default receive limit (an
    SF1 tablet is tens of MiB) arrives: the port's channels lift the
    limit. The reference's refuse it with RESOURCE_EXHAUSTED, which its
    routed view turns into ReadUnavailable (ROADMAP Queue 3)."""
    from dgraph_tpu_torch.store.schema import parse_schema
    b = port_store.StoreBuilder(parse_schema(
        "e: [uid] @reverse .\nname: string @index(exact) ."))
    rng = np.random.default_rng(0)
    n = 200_000
    b.add_edges("e", rng.integers(1, n, 700_000),
                rng.integers(1, n, 700_000))
    b.add_value(1, "name", "x")
    full = b.finalize()
    bases = [port_store.Store(full.uids, full.schema,
                              {p: full.preds[p]}) for p in ("name", "e")]
    zs, zport, _st = port_zero.make_zero_server()
    zs.start()
    zt = f"127.0.0.1:{zport}"
    nodes = [port_cluster.start_cluster_alpha(
        zt, base=base, device_threshold=10**9, device="cpu")
        for base in bases]
    try:
        zc = port_zero.ZeroClient(zt)
        for (a, _s, _addr), pred in zip(nodes, ("name", "e")):
            zc.should_serve(pred, a.groups.gid)
        for a, _s, _addr in nodes:
            a.groups.refresh()
        a1 = nodes[0][0]
        a1.remote_hop_max = 0
        t0 = METRICS.get("tablet_bytes_fetched")
        out = a1.query('{ q(func: eq(name, "x")) { e { uid } } }')
        assert METRICS.get("tablet_bytes_fetched") - t0 > 4 << 20
        want = port_api.Alpha(base=full, device="cpu",
                              device_threshold=10**9).query(
            '{ q(func: eq(name, "x")) { e { uid } } }')
        assert out == want and out["q"][0]["e"]
    finally:
        for _a, s, _addr in nodes:
            s.stop(None)
        zs.stop(None)
