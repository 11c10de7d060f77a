"""The port's mesh across processes: two OS processes, each with two CPU
shards, form one 4-shard mesh over a gloo process group.

The reference's `tests/test_multihost.py` runs its two cases as two
`jax.distributed` processes. Here the same cases run as port children
(no jax) over `parallel/mesh.init_distributed` on `tcp://127.0.0.1:<free
port>`:

* (a) the three queries of `test_multihost.WORKER` on the 4-shard
  cross-process mesh, byte-equal on both ranks to the port's host
  engine and to a reference two-process child's answers (this file
  starts it; it prints its answers as JSON); and `SHARDED_WORKER`'s
  disjoint-slab `matrix_hop`, whose edges must equal the CSR walk, with
  `assemble_sharded_rel`'s arrays equal to `device_put_rel`'s on each
  rank's shards; and, with `ring_threshold` lowered, an ordered child
  level whose expansion rides the sharded ring across the processes;
* (b) every mesh program (the eight of `dhop.py`, `mesh_topk`,
  `mesh_row_sort`, `bitmap_recurse_sharded`, `knn_mesh`, `feat_mesh`
  with sum, mean and max) across the two processes, exactly equal to the
  same program on a one-process 4-shard CPU mesh (which
  `test_torch_parallel.py` holds to the reference);
* (c) the rules: a fully local mesh inside the group makes no
  cross-process call, `np.asarray` of a value with other processes'
  parts raises, a coordinator without a rank raises ValueError, when
  one rank exits before a collective the other raises within the
  group's timeout, `query_batch` forms the same kernel groups on every
  rank whatever one rank's priors say, an Alpha over such a mesh
  refuses admission control, and a process offers the card its device
  names;
* (d) two `python -m dgraph_tpu_torch alpha --device cpu
  --jax-coordinator ... --mesh-devices -1` processes serve the same
  alter, commit and (concurrently) query, answer as a plain CPU Alpha
  does, and exit 0 on SIGINT.

Every child is waited for with a timeout and killed past it, and the
process group's own timeout (DGRAPH_TPU_DIST_TIMEOUT_S) bounds every
rendezvous and collective, so no case can hang.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 240           # the longest a pair of children may take
GROUP_TIMEOUT_S = 60    # the process group's timeout in the children

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["DGRAPH_TPU_DIST_TIMEOUT_S"] = str(GROUP_TIMEOUT_S)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "JAX_DIST_AUTO", "DGRAPH_TPU_LOCAL_SHARDS"):
        env.pop(var, None)
    env.update(extra)
    return env


def _run_pair(tmp_path, name: str, source: str, env=None) -> list:
    """Run `source` as ranks 0 and 1 (argv: rank, port, out dir); returns
    each rank's (returncode, output). Children past CHILD_S are killed."""
    port = _free_port()
    script = tmp_path / f"{name}.py"
    script.write_text(source)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT,
        env=env or _env(DGRAPH_TPU_LOCAL_SHARDS="2"), text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_S)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _ok(outs) -> None:
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"


# -- the port's children ------------------------------------------------------

PRELUDE = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from dgraph_tpu_torch.parallel import mesh as M
assert M.init_distributed(f"127.0.0.1:{port}", 2, rank)
mesh = M.make_mesh(device="cpu")
assert mesh.size == 4 and mesh.local == (2 * rank, 2 * rank + 1), mesh
assert mesh.backend == "gloo" and mesh.spans_processes
assert "jax" not in sys.modules
report = {"mesh": repr(mesh)}

def save():
    with open(os.path.join(out_dir, f"{NAME}.{rank}.json"), "w") as f:
        json.dump(report, f)
"""

QUERIES = (
    '{ q(func: eq(name, "p7")) { name friend { name friend { name } } } }',
    '{ q(func: uid(0x1)) @recurse(depth: 3, loop: false) { uid friend } }',
    '{ q(func: has(friend), first: 5) { name count(friend) } }',
)

# test_multihost.WORKER's store, built the same way by either package
STORE_SRC = r"""
def worker_store(StoreBuilder, parse_schema):
    b = StoreBuilder(parse_schema(
        "name: string @index(exact) .\nfriend: [uid] @reverse ."))
    rng = np.random.default_rng(5)
    n = 500
    for u in range(1, n + 1):
        b.add_value(u, "name", f"p{u}")
    src = rng.integers(1, n + 1, 3000); dst = rng.integers(1, n + 1, 3000)
    for s, d in zip(src.tolist(), dst.tolist()):
        if s != d:
            b.add_edge(s, "friend", d)
    return b.finalize()
"""

QUERY_WORKER = PRELUDE + STORE_SRC + r"""
NAME = "queries"
QUERIES = %r
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.parallel import dhop
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder
store = worker_store(StoreBuilder, parse_schema)
host = Engine(store, device="cpu", device_threshold=10**9)
M.PROGRAM_CALLS.clear()
before = sum(M.CROSS_CALLS.values())
meshe = Engine(store, device="cpu", device_threshold=0, mesh=mesh)
report["mesh_answers"] = [meshe.query_bytes(q).decode() for q in QUERIES]
report["host_answers"] = [host.query_bytes(q).decode() for q in QUERIES]
report["programs"] = dict(M.PROGRAM_CALLS)
report["cross_calls"] = sum(M.CROSS_CALLS.values()) - before
report["mesh_routes"] = {k: v for k, v in meshe.routes.expansions.items()
                         if v}

# query_batch over the mesh: a recurse group smaller than MIN_BATCH whose
# shape has, on rank 0 only, a prior above KERNEL_WORTH_US goes to the
# mesh on both ranks (a lane kernel on one rank would leave the other
# waiting at a collective)
from dgraph_tpu_torch.engine import batch as B
from dgraph_tpu_torch.utils import costprior
from dgraph_tpu_torch.utils.metrics import METRICS
SMALL = ["{ q(func: uid(%%d)) @recurse(depth: 3) { friend uid } }" %% u
         for u in (1, 2)]
if rank == 0:
    for _ in range(costprior.PRIORS.sample_floor):
        costprior.PRIORS.learn("read", None, "recurse:friend~d3",
                               2 * B.KERNEL_WORTH_US)
report["prior_worth"] = B._kernel_worth("recurse:friend~d3", len(SMALL))
launches = METRICS.get("kernel_group_launches_total", family="recurse")
M.PROGRAM_CALLS.clear()
got = B.query_batch(store, SMALL, device="cpu", device_threshold=0,
                    mesh=mesh)
report["batch_answers"] = [json.dumps(g, sort_keys=True) for g in got]
report["batch_host"] = [json.dumps(host.query(q), sort_keys=True)
                        for q in SMALL]
report["batch_kernel_groups"] = METRICS.get(
    "kernel_group_launches_total", family="recurse") - launches
report["batch_programs"] = dict(M.PROGRAM_CALLS)

# the sharded ring: frontiers past ring_threshold rotate their chunks,
# and the stitch reads every shard's edges through one gather per column
from dgraph_tpu_torch.engine.execute import Executor
Executor.ring_threshold = 4
M.PROGRAM_CALLS.clear()
ringe = Engine(store, device="cpu", device_threshold=0, mesh=mesh)
RING_Q = ("{ q(func: has(friend), first: 40) "
          "{ uid friend (orderasc: name) { name } } }")
report["ring_answer"] = ringe.query_bytes(RING_Q).decode()
report["ring_programs"] = dict(M.PROGRAM_CALLS)
Executor.ring_threshold = 1 << 17
report["ring_host"] = host.query_bytes(RING_Q).decode()

# np.asarray of a value with the other process's parts raises; host_np
# gathers it (both ranks call it)
fr = np.full(64, 2**31 - 1, np.int32)
fr[:4] = [1, 100, 300, 450]
out = dhop.matrix_hop(mesh, store.sharded_rel("friend", False, mesh), fr, 512)
try:
    np.asarray(out[0])
    report["asarray"] = "no error"
except RuntimeError as e:
    report["asarray"] = str(e)
report["gathered_shape"] = list(M.host_np(out[0]).shape)
report["replicated_int"] = int(out[4])

# a mesh of this process's own shards inside the group: no cross-process
# call, whatever it serves
local = M.make_mesh(devices=["cpu", "cpu"])
before = dict(M.CROSS_CALLS)
M.PROGRAM_CALLS.clear()
loce = Engine(worker_store(StoreBuilder, parse_schema), device="cpu",
              device_threshold=0, mesh=local)
report["local_answers"] = [loce.query_bytes(q).decode() for q in QUERIES]
report["local_programs"] = dict(M.PROGRAM_CALLS)
report["local_cross_calls"] = {k: v - before.get(k, 0)
                               for k, v in M.CROSS_CALLS.items()
                               if v != before.get(k, 0)}
save()
M.shutdown_distributed()
""" % (QUERIES,)

REF_QUERY_WORKER = STORE_SRC + r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from dgraph_tpu.parallel.mesh import init_distributed, make_mesh
assert init_distributed(f"127.0.0.1:{port}", 2, pid)
assert len(jax.devices()) == 4 and len(jax.local_devices()) == 2
from dgraph_tpu.engine import Engine
from dgraph_tpu.store import StoreBuilder, parse_schema
meshe = Engine(worker_store(StoreBuilder, parse_schema), device_threshold=0,
               mesh=make_mesh())
answers = [meshe.query_bytes(q).decode() for q in %r]
with open(os.path.join(out_dir, f"ref.{pid}.json"), "w") as f:
    json.dump(answers, f)
""" % (QUERIES,)

# every mesh program on `mesh`, from seeded inputs: run by the children
# on the cross-process mesh and by this file on a one-process mesh
PROGRAMS_SRC = r"""
from dgraph_tpu_torch.engine import feat as _feat
from dgraph_tpu_torch.models.synthetic import powerlaw_rel as _powerlaw
from dgraph_tpu_torch.parallel import dbfs as _dbfs
from dgraph_tpu_torch.parallel import dhop as _dhop
from dgraph_tpu_torch.parallel import dsort as _dsort
from dgraph_tpu_torch.parallel import pshard as _pshard
from dgraph_tpu_torch.parallel.mesh import host_np as _host_np
from dgraph_tpu_torch.store import vec as _vec
from dgraph_tpu_torch.store.schema import parse_schema as _parse
from dgraph_tpu_torch.store.store import StoreBuilder as _Builder

_S = 2**31 - 1


def _pad(a, n):
    out = np.full(n, _S, np.int32)
    out[:len(a)] = a
    return out


def _sort_store():
    rng = np.random.default_rng(5)
    b = _Builder(_parse("score: int @index(int) .\nheight: float .\n"
                        "name: string ."))
    for u in range(1, 301):
        b.add_value(u, "score", int(rng.integers(0, 10_000)))
        if u % 3:
            b.add_value(u, "height", float(rng.uniform(1.0, 2.0)))
        b.add_value(u, "name", f"n{int(rng.integers(0, 200))}")
    return b.finalize()


def _vec_store():
    rng = np.random.default_rng(7)
    b = _Builder(_parse("emb: float32vector @dim(8) ."))
    for u in range(1, 251):
        if u % 5:
            b.add_value(u, "emb", [float(x) for x in
                                   rng.normal(size=8).astype(np.float32)])
    return b.finalize()


def program_cases(mesh):
    D = mesh.size
    n = 503
    rel = _powerlaw(n, 7.0, seed=0)
    srel = _pshard.device_put_rel(_pshard.shard_rel(rel, D), mesh)
    rng = np.random.default_rng(1)
    fr = np.unique(rng.integers(0, n, 100)).astype(np.int32)
    chunks = _pshard.shard_frontier(fr, D, 32)
    allowed = _pad(np.arange(0, n, 3, dtype=np.int32), 256)
    seeds = _pad(np.array([3, 77], np.int32), 1024)
    seen = _pad(np.array([3, 77], np.int32), 2048)
    seeds20 = _pad(np.arange(20, dtype=np.int32), 32)
    yield "scatter_gather_hop", lambda: _dhop.scatter_gather_hop(
        mesh, srel, _pad(fr, 128), 4096, 1024)
    yield "scatter_gather_hop_overflow", lambda: _dhop.scatter_gather_hop(
        mesh, srel, _pad(fr, 128), 16, 32)
    yield "matrix_hop", lambda: _dhop.matrix_hop(mesh, srel, _pad(fr, 128),
                                                 512)
    yield "matrix_level", lambda: _dhop.matrix_level(
        mesh, srel, _pad(fr, 128), allowed, 1, 2, 512, True)
    yield "ring_hop", lambda: _dhop.ring_hop(mesh, srel, chunks, 4096, 1024)
    yield "ring_matrix_hop", lambda: _dhop.ring_matrix_hop(mesh, srel,
                                                           chunks, 128)
    yield "recurse_fused", lambda: _dhop.recurse_fused(
        mesh, srel, seeds, 8192, 1024, 2048, 3)
    yield "recurse_fused_overflow", lambda: _dhop.recurse_fused(
        mesh, srel, seeds20, 4096, 32, 64, 2)
    yield "recurse_fused_matrix", lambda: _dhop.recurse_fused_matrix(
        mesh, srel, seeds, 8192, 1024, 2048, 3)
    yield "chain_hop", lambda: _dhop.chain_hop(mesh, srel, seeds, seen,
                                               8192, 1024, 2048)
    sstore = _sort_store()
    ranks = np.unique(rng.integers(0, 300, 200)).astype(np.int32)
    yield "mesh_topk", lambda: _dsort.mesh_topk(mesh, sstore, "score", "",
                                                ranks, 17)
    yield "mesh_topk_desc", lambda: _dsort.mesh_topk(
        mesh, sstore, "height", "", ranks, 1000, desc=True)
    nb = rng.integers(0, 300, 400).astype(np.int32)
    sg = np.sort(rng.integers(0, 40, 400)).astype(np.int32)
    yield "mesh_row_sort", lambda: _dsort.mesh_row_sort(
        mesh, sstore, "name", "", nb, sg, desc=True)
    src_s, dst_s, deg_s, rows = _dbfs.shard_coo_by_src(rel.indptr,
                                                       rel.indices, D)
    m0 = np.zeros((n, 16), np.int8)
    m0[rng.integers(0, n, 40), rng.integers(0, 16, 40)] = 1
    slabs = _dbfs.shard_mask(m0, D, rows)
    yield "bitmap_recurse_sharded", lambda: _dbfs.bitmap_recurse_sharded(
        mesh, src_s, dst_s, deg_s, slabs, 3)
    vstore = _vec_store()
    q = rng.normal(size=8).astype(np.float32)
    yield "knn_mesh", lambda: _vec._mesh_topk(vstore, "emb", q, 9, mesh,
                                              ("emb", 8, 9))
    vn = rng.integers(0, 250, 600).astype(np.int32)
    vs = np.sort(rng.integers(-1, 60, 600)).astype(np.int32)
    for agg in ("sum", "mean", "max"):
        yield f"feat_mesh_{agg}", (lambda agg=agg: _feat._mesh_combine(
            vstore, "emb", vn, vs, 60, agg, mesh, ("emb", 8, agg)))


def host_outputs(out):
    # every output of a program as host arrays (host_np gathers the
    # other processes' parts)
    if out is None:
        return []
    if isinstance(out, np.ndarray):
        return [out]
    return [np.asarray(_host_np(o)) for o in out]
"""

PROGRAM_NAMES = [
    "scatter_gather_hop", "scatter_gather_hop_overflow", "matrix_hop",
    "matrix_level", "ring_hop", "ring_matrix_hop", "recurse_fused",
    "recurse_fused_overflow", "recurse_fused_matrix", "chain_hop",
    "mesh_topk", "mesh_topk_desc", "mesh_row_sort",
    "bitmap_recurse_sharded", "knn_mesh", "feat_mesh_sum",
    "feat_mesh_mean", "feat_mesh_max"]

PROGRAM_WORKER = PRELUDE + PROGRAMS_SRC + r"""
NAME = "programs"
from dgraph_tpu_torch.models.synthetic import powerlaw_rel
from dgraph_tpu_torch.parallel.pshard import (assemble_sharded_rel,
                                              device_put_rel, shard_rel)

# the reference's SHARDED_WORKER: this process keeps only the slabs of
# the shards it owns; the assembled relation is the only place all four
# coexist
n = 640
rel = powerlaw_rel(n, 8.0, seed=9)
full = shard_rel(rel, mesh.size)
local = {}
for d in mesh.local:
    lptr = full.indptr_s[d]
    local[d] = (lptr, full.indices_s[d, :int(lptr[-1])])
placed = device_put_rel(full, mesh)
del full
c0 = dict(M.CROSS_CALLS)
srel = assemble_sharded_rel(mesh, n, local)
report["assemble_calls"] = {k: v - c0.get(k, 0) for k, v in
                            M.CROSS_CALLS.items() if v != c0.get(k, 0)}
report["disjoint"] = not srel.indices_s.fully_held and all(
    srel.indices_s.parts[d] is None for d in range(mesh.size)
    if d not in mesh.local)
report["assembled_equal"] = all(
    torch.equal(getattr(srel, a).parts[d], getattr(placed, a).parts[d])
    for a in ("indptr_s", "indices_s") for d in mesh.local) and \
    np.array_equal(srel.row_lo, placed.row_lo) and \
    np.array_equal(srel.pos_lo, placed.pos_lo)
frontier = np.array(sorted({1, 5, n // 2 + 3, n - 7, n - 2}), np.int32)
deg = (rel.indptr[frontier + 1] - rel.indptr[frontier]).astype(np.int64)
edge_cap = 64
while edge_cap < max(int(deg.sum()), 1):
    edge_cap <<= 1
nbrs_s, seg_s, _pos_s, totals, max_e = _dhop.matrix_hop(
    mesh, srel, _pad(frontier, 8), edge_cap)
assert int(M.host_np(max_e)) <= edge_cap
nbrs_h, seg_h, totals_h = (M.host_np(nbrs_s), M.host_np(seg_s),
                           M.host_np(totals))
got = np.concatenate([np.stack([seg_h[d, :int(totals_h[d])],
                                nbrs_h[d, :int(totals_h[d])]])
                      for d in range(mesh.size)], axis=1)
got = got[:, np.lexsort((got[1], got[0]))]
want = np.array([[i, int(o)] for i, f in enumerate(frontier)
                 for o in rel.indices[rel.indptr[f]:rel.indptr[f + 1]]]).T
want = want[:, np.lexsort((want[1], want[0]))]
report["sharded_hop_equal"] = bool(np.array_equal(got, want))
report["sharded_hop_edges"] = int(want.shape[1])

outs = {}
for name, run in program_cases(mesh):
    for i, a in enumerate(host_outputs(run())):
        outs[f"{name}/{i}"] = a
np.savez(os.path.join(out_dir, f"programs.{rank}.npz"), **outs)
report["cases"] = sorted({k.split("/")[0] for k in outs})
save()
M.shutdown_distributed()
"""

DEAD_WORKER = r"""
import os, sys, time
rank, port = int(sys.argv[1]), sys.argv[2]
from dgraph_tpu_torch.parallel import mesh as M
assert M.init_distributed(f"127.0.0.1:{port}", 2, rank)
if rank == 1:
    os._exit(0)      # gone before the first collective
time.sleep(1.0)
t0 = time.monotonic()
try:
    M.make_mesh(device="cpu")
    print("NO ERROR", flush=True)
except Exception as e:   # the collective's own failure
    print(f"RAISED {type(e).__name__} after {time.monotonic() - t0:.2f} s",
          flush=True)
"""


@pytest.fixture(scope="module")
def query_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("queries")
    _ok(_run_pair(tmp, "queries", QUERY_WORKER))
    ref = tmp_path_factory.mktemp("ref")
    _ok(_run_pair(ref, "ref", REF_QUERY_WORKER, env=_env(
        JAX_PLATFORMS="cpu")))
    port = [json.loads((tmp / f"queries.{r}.json").read_text())
            for r in range(2)]
    answers = [json.loads((ref / f"ref.{r}.json").read_text())
               for r in range(2)]
    return port, answers


@pytest.fixture(scope="module")
def program_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("programs")
    _ok(_run_pair(tmp, "programs", PROGRAM_WORKER))
    reports = [json.loads((tmp / f"programs.{r}.json").read_text())
               for r in range(2)]
    outs = [dict(np.load(tmp / f"programs.{r}.npz")) for r in range(2)]
    return reports, outs


@pytest.fixture(scope="module")
def single_process_programs():
    ns = {"np": np}
    exec(PROGRAMS_SRC, ns)
    mesh = pmesh.make_mesh(4, device="cpu")
    assert not mesh.spans_processes
    outs = {}
    for name, run in ns["program_cases"](mesh):
        outs[name] = ns["host_outputs"](run())
    return outs


# -- (a) the reference's two cases ------------------------------------------------

@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_reference_query_on_two_processes(i, query_runs):
    """Each of test_multihost.WORKER's queries: byte-equal on both ranks
    of the cross-process mesh, to the port's host engine and to the
    reference's own two-process run."""
    port, ref = query_runs
    host = port[0]["host_answers"][i]
    assert port[0]["mesh_answers"][i] == host
    assert port[1]["mesh_answers"][i] == host
    assert ref[0][i] == ref[1][i] == host


def test_queries_ran_on_the_mesh_across_processes(query_runs):
    port, _ref = query_runs
    for r in port:
        assert set(r["mesh_routes"]) <= {"mesh", "mesh_level", "mesh_chain",
                                         "empty"}, r["mesh_routes"]
        assert r["programs"].get("matrix_level") and \
            r["programs"].get("chain_hop"), r["programs"]
        assert r["cross_calls"] > 0
        assert "cpu@0, cpu@0, cpu@1, cpu@1; gloo" in r["mesh"]


def test_ring_stitch_across_processes(query_runs):
    """With ring_threshold lowered the expansions ride the sharded ring
    across both processes, and the answers stay the host engine's."""
    port, _ref = query_runs
    for r in port:
        assert r["ring_programs"].get("ring_matrix_hop"), r["ring_programs"]
        assert r["ring_answer"] == r["ring_host"]


def test_disjoint_slabs_hop_across_processes(program_runs):
    """SHARDED_WORKER: each process holds only its slabs; the assembled
    relation equals device_put_rel on its shards, agreed by one gather,
    and the hop over a frontier spanning both processes' rows is the CSR
    walk."""
    reports, _outs = program_runs
    for r in reports:
        assert r["disjoint"] and r["assembled_equal"]
        assert r["assemble_calls"] == {"nnz": 1}
        assert r["sharded_hop_equal"] and r["sharded_hop_edges"] > 0


# -- (b) every program across processes ---------------------------------------------

@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_program_across_processes_equals_one_process(
        name, program_runs, single_process_programs):
    reports, outs = program_runs
    assert reports[0]["cases"] == reports[1]["cases"] == sorted(
        PROGRAM_NAMES)
    want = single_process_programs[name]
    for r in range(2):
        got = [outs[r][f"{name}/{i}"] for i in range(len(want))]
        assert not any(k == f"{name}/{len(want)}" for k in outs[r])
        for i, (a, b) in enumerate(zip(want, got)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            # exactly: float sums fold in shard order on both sides
            assert a.tobytes() == b.tobytes(), (name, i, r)


# -- (c) the rules ---------------------------------------------------------------------

def test_query_batch_forms_the_same_groups_on_every_rank(query_runs):
    """A group below MIN_BATCH that rank 0's prior alone calls worth a
    lane kernel goes to the mesh on both ranks: the count rule alone
    forms the groups while the mesh spans processes."""
    port, _ref = query_runs
    assert port[0]["prior_worth"] and not port[1]["prior_worth"]
    for r in port:
        assert r["batch_answers"] == r["batch_host"]
        assert r["batch_kernel_groups"] == 0
        assert r["batch_programs"], r["batch_programs"]
    assert port[0]["batch_answers"] == port[1]["batch_answers"]


def test_fully_local_mesh_in_a_group_makes_no_cross_process_call(
        query_runs):
    port, _ref = query_runs
    for r in port:
        assert r["local_cross_calls"] == {}
        assert r["local_programs"].get("matrix_level")
        assert r["local_answers"] == r["host_answers"]


def test_asarray_of_foreign_parts_raises(query_runs):
    port, _ref = query_runs
    for r in port:
        assert "reads through host_np" in r["asarray"]
        assert r["gathered_shape"] == [4, 512]
        assert r["replicated_int"] > 0


def test_coordinator_without_rank_raises(monkeypatch):
    for var in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match=r"without this process's rank"):
        pmesh.init_distributed("127.0.0.1:1")
    monkeypatch.setenv("JAX_PROCESS_ID", "-1")
    with pytest.raises(ValueError, match=r"JAX_PROCESS_ID"):
        pmesh.init_distributed("127.0.0.1:1")
    assert not pmesh.init_distributed()     # no coordinator: no group


def test_alpha_over_a_mesh_across_processes_refuses_admission():
    """Admission sheds per process, so a request shed on one rank and
    served on another would put the ranks out of step: refused."""
    from dgraph_tpu_torch.server.api import Alpha
    spanning = pmesh.Mesh(["cpu"] * 4, ranks=(0, 0, 1, 1), rank=0)
    assert spanning.spans_processes
    with pytest.raises(ValueError, match="sheds per process"):
        Alpha(device="cpu", mesh=spanning).attach_admission(2, 2)
    local = pmesh.make_mesh(2, device="cpu")
    assert Alpha(device="cpu", mesh=local).attach_admission(2, 2)


def test_local_devices_keep_the_card_a_device_names(monkeypatch):
    """`cuda:1` offers card 1 whatever LOCAL_RANK says; a bare "cuda" is
    card LOCAL_RANK, else this rank modulo the cards; a card past the
    count raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv(pmesh.LOCAL_SHARDS_ENV, "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    one = torch.device("cuda", 1)
    assert pmesh._local_devices(one) == [one, one]
    assert pmesh._local_devices(torch.device("cuda")) == \
        [torch.device("cuda", 0)] * 2
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pmesh._local_devices(torch.device("cuda")) == [one, one]
    monkeypatch.delenv("LOCAL_RANK")
    assert pmesh._local_devices(torch.device("cuda")) == \
        [torch.device("cuda", 0)] * 2       # rank 0 outside a group
    with pytest.raises(ValueError, match=r"requested device cuda:2, have 2"):
        pmesh._local_devices(torch.device("cuda", 2))


def test_dead_rank_raises_within_the_timeout(tmp_path):
    timeout = 15
    outs = _run_pair(tmp_path, "dead", DEAD_WORKER, env=_env(
        DGRAPH_TPU_DIST_TIMEOUT_S=str(timeout)))
    _ok(outs)
    line = [x for x in outs[0][1].splitlines() if x.startswith(("RAISED",
                                                                "NO "))]
    assert line and line[0].startswith("RAISED"), outs[0][1][-3000:]
    assert float(line[0].split()[-2]) < timeout + 10


# -- (d) the CLI -----------------------------------------------------------------------

SCHEMA = "name: string @index(exact) .\nfriend: [uid] @reverse ."
RDF = "\n".join(f'_:p{i} <name> "p{i}" .\n_:p{i} <friend> _:p{(i * 7 + 3) % 40} .'
                for i in range(40))
CLI_Q = '{ q(func: eq(name, "p1")) { name friend { name friend { name } } } }'


def _post(base, path, body, ctype="application/dql", timeout=60):
    req = urllib.request.Request(base + path, data=body.encode(),
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_up(proc, base, limit_s=120.0):
    deadline = time.monotonic() + limit_s
    while True:
        try:
            urllib.request.urlopen(base + "/health", timeout=5).read()
            return
        except OSError:
            assert proc.poll() is None, "the alpha exited"
            assert time.monotonic() < deadline, "the alpha never listened"
            time.sleep(0.2)


def test_two_alpha_processes_serve_one_mesh(tmp_path):
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.server.api import Alpha

    coord = f"127.0.0.1:{_free_port()}"
    hports = [_free_port(), _free_port()]
    logs = [tmp_path / f"alpha{r}.log" for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dgraph_tpu_torch", "alpha",
                     "--device", "cpu", "--p", str(tmp_path / f"p{r}"),
                     "--http_port", str(hports[r]),
                     "--grpc_port", str(_free_port()),
                     "--jax-coordinator", coord, "--mesh-devices", "-1",
                     "--store", "device_threshold=0", "--ts_interval_s", "0"],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                    env=_env(JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r),
                             DGRAPH_TPU_LOCAL_SHARDS="2")))
        bases = [f"http://127.0.0.1:{p}" for p in hports]
        for proc, base in zip(procs, bases):
            _wait_up(proc, base)
        for base in bases:
            _post(base, "/alter", SCHEMA)
        for base in bases:
            _post(base, "/mutate?commitNow=true", RDF,
                  ctype="application/rdf")
        got: dict = {}
        threads = [threading.Thread(target=lambda r=r: got.update(
            {r: _post(bases[r], "/query", CLI_Q)})) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        plain = Alpha(device="cpu", device_threshold=10**9)
        plain.alter(SCHEMA)
        plain.mutate(set_nquads=RDF)
        want = json.loads(Engine(plain.mvcc.read_view(
            plain.oracle.read_ts()), device="cpu").query_bytes(CLI_Q))
        assert got[0]["data"] == got[1]["data"] == want
        for proc in procs:
            proc.send_signal(signal.SIGINT)
        for proc in procs:
            assert proc.wait(timeout=120) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    text = [log.read_text() for log in logs]
    for r, t in enumerate(text):
        assert f"multi-process runtime: process {r}/2" in t, t[-3000:]
        assert "device mesh across 2 processes over gloo" in t, t[-3000:]
        assert f"holds shards [{2 * r}, {2 * r + 1}]" in t, t[-3000:]
        assert "draining maintenance" in t


def test_collective_sites_are_the_mesh_modules_only():
    """The facts inventory lists every torch.distributed call, and every
    one lies in parallel/mesh.py: the group, the mesh's shape exchange
    and the cross-process gathers (graftlint R7 keeps them there)."""
    from dgraph_tpu_torch.analysis import run
    sites = run().facts["collective_sites"]
    assert {s["file"] for s in sites} == {"dgraph_tpu_torch/parallel/mesh.py"}
    assert {"init_process_group", "new_group", "all_gather_object",
            "all_gather", "destroy_process_group"} <= {s["call"]
                                                       for s in sites}
    assert not {"all_reduce", "reduce_scatter", "broadcast"} & {
        s["call"] for s in sites}
