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
  cross-process call, nor does an Alpha over it or without a mesh,
  `np.asarray` of a value with other processes' parts raises, a
  coordinator without a rank raises ValueError, when one rank exits
  before a collective the other raises within the group's timeout, a
  follower that cannot read the lead's decision raises naming its key,
  and a process offers the card its device names;
* (e) the lead decides, every rank follows (`parallel/mesh.agree`): an
  Alpha on each rank with admission armed sheds and serves the same
  requests whichever rank's token is held, with the lead's Retry-After,
  forecast sheds and displacements are the lead's alone, `query_batch`
  forms its lane-kernel groups from rank 0's priors, a learned route
  promotion of rank 0 sends a request to the mesh on both ranks, and
  every served answer is the reference's two-process answer;
* (f) failures every rank sees (`parallel/mesh.py`'s status rounds): an
  allocation failure on rank 1 alone at each of the four mesh sites is
  retried by both ranks, two in a row raise the same class on both, a
  budget out on rank 1 alone ends the read on both with one stage, two
  distinct reads started in opposite orders are served on both, an
  upsert failing on rank 1 alone in or before its mesh route leaves the
  next read served, two different programs raise on both and fold
  nothing, a failure after a program's last collective is seen by both,
  a one-process mesh makes no round, and the decision store stays
  bounded;
* (d) two `python -m dgraph_tpu_torch alpha --device cpu
  --jax-coordinator ... --mesh-devices -1 --max_inflight 2` processes
  serve the same alter, commit and (concurrently) query, answer as a
  plain CPU Alpha does, and exit 0 on SIGINT.

Every child is waited for with a timeout and killed past it, and the
process group's own timeout (DGRAPH_TPU_DIST_TIMEOUT_S) bounds every
rendezvous and collective, so no case can hang.
"""

import datetime
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
    # a level of 100 rows: under a device_threshold of 10**9 only a
    # learned promotion sends it to the mesh
    '{ q(func: has(friend), first: 100) { name friend { name } } }',
)
# an ordered child level: its expansion is `mesh.matrix_hop`'s, or past
# a lowered ring_threshold `mesh.ring_matrix_hop`'s
RING_Q = ("{ q(func: has(friend), first: 40) "
          "{ uid friend (orderasc: name) { name } } }")

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
RING_Q = %r
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
# shape has, on rank 0 only, a prior above KERNEL_WORTH_US is a lane
# kernel on both ranks (the lead's answer, agreed once for the batch)
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
c0 = dict(M.CROSS_CALLS)
got = B.query_batch(store, SMALL, device="cpu", device_threshold=0,
                    mesh=mesh)
report["batch_agree"] = M.CROSS_CALLS.get("agree", 0) - c0.get("agree", 0)
report["batch_answers"] = [json.dumps(g, sort_keys=True) for g in got]
report["batch_host"] = [json.dumps(host.query(q), sort_keys=True)
                        for q in SMALL]
report["batch_kernel_groups"] = METRICS.get(
    "kernel_group_launches_total", family="recurse") - launches
report["batch_programs"] = dict(M.PROGRAM_CALLS)

# an Alpha over the mesh: the lead (rank 0) decides, every rank follows
import threading, time
from dgraph_tpu_torch.server.admission import ServerOverloaded
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.utils import timeseries
alpha = Alpha(base=store, device="cpu", device_threshold=0, mesh=mesh)
agree0 = M.CROSS_CALLS.get("agree", 0)
asked = 0

def ask(q):
    global asked
    asked += 1
    try:
        return {"served": alpha.query_raw(q).decode()}
    except ServerOverloaded as e:
        return {"shed": e.reason, "retry_after_s": e.retry_after_s}

def hold():
    # a local request holds this rank's read token until released
    got, done = threading.Event(), threading.Event()
    def run():
        with alpha.admission.admit("read"):
            got.set()
            done.wait(60)
    t = threading.Thread(target=run)
    t.start()
    assert got.wait(60)
    def release():
        done.set()
        t.join(60)
    return release

def queued(n):
    lane = alpha.admission.lanes["read"]
    limit = time.monotonic() + 60
    while lane.status()["queued"] != n:
        assert time.monotonic() < limit, lane.status()
        time.sleep(0.01)

def read_lane():
    st = alpha.admission.status()["lanes"]["read"]
    return {k: st[k] for k in ("admitted_total", "shed_total")}

# (i) admission with unequal loads: one token, no queue
alpha.attach_admission(1, 0)
adm = {}
for step, holder in (("held_0", 0), ("free", None), ("held_1", 1)):
    release = hold() if rank == holder else None
    adm[step] = ask(QUERIES[0])
    if release is not None:
        release()
adm["lane"] = read_lane()
report["admission"] = adm

# (ii) forecast shedding: a queue, and a forecast that always says shed,
# armed on one rank at a time while that rank's token is held
class AlwaysShed:
    def should_shed(self, lane, cost_us, max_inflight):
        return True

alpha.attach_admission(1, 1)
fc = {}
f0 = METRICS.get("forecast_sheds_total", lane="read")
for step, armed in (("lead", 0), ("follower", 1)):
    release = None
    if rank == armed:
        timeseries._FORECAST = AlwaysShed()
        release = hold()
    fc[step] = ask(QUERIES[1])
    if release is not None:
        release()
        timeseries._FORECAST = None
fc["forecast_sheds"] = METRICS.get("forecast_sheds_total", lane="read") - f0
report["forecast"] = fc

# (iii) a displaced waiter: on the lead an expensive request waits in the
# one queue slot, and a cheaper arrival displaces it
alpha.attach_admission(1, 1)
EXPENSIVE, CHEAP = QUERIES[0], QUERIES[2]
dis = {}
if rank == 0:
    alpha._predict = lambda lane, text: (
        (1e9 if text == EXPENSIVE else 10.0), "test")
    release = hold()
    ta = threading.Thread(target=lambda: dis.update(a=ask(EXPENSIVE)))
    ta.start()
    queued(1)
    tb = threading.Thread(target=lambda: dis.update(b=ask(CHEAP)))
    tb.start()
    ta.join(60)
    queued(1)
    release()
    tb.join(60)
    del alpha._predict
else:
    dis["a"] = ask(EXPENSIVE)
    dis["b"] = ask(CHEAP)
dis["lane"] = read_lane()
report["displaced"] = dis

# (iv) route promotion: under a device_threshold of 10**9 rank 0's route
# EMAs say the mesh beats the host walk and rank 1's say the opposite
alpha.admission = None
alpha.device_threshold = 10**9
fast, slow = (("mesh", "numpy") if rank == 0 else ("numpy", "mesh"))
for _ in range(64):
    costprior.PRIORS.learn_route(fast, 1.0)
    costprior.PRIORS.learn_route(slow, 1000.0)
report["own_promotion"] = costprior.promoted("mesh", "numpy")

def mesh_routes():
    return {r: METRICS.get("mesh_route_total", route=r)
            for r in ("mesh", "numpy", "empty")}

r0 = mesh_routes()
report["promoted_answer"] = ask(QUERIES[3])
report["promoted_routes"] = {k: v - r0[k] for k, v in mesh_routes().items()}
# outside a granted request no rank's own EMAs choose the mesh
r0 = mesh_routes()
plain = Engine(store, device="cpu", device_threshold=10**9, mesh=mesh)
report["ungranted_answer"] = plain.query_bytes(QUERIES[3]).decode()
report["ungranted_routes"] = {k: v - r0[k] for k, v in mesh_routes().items()}
report["alpha_requests"] = asked
report["alpha_agree"] = M.CROSS_CALLS.get("agree", 0) - agree0

# the sharded ring: frontiers past ring_threshold rotate their chunks,
# and the stitch reads every shard's edges through one gather per column
from dgraph_tpu_torch.engine.execute import Executor
Executor.ring_threshold = 4
M.PROGRAM_CALLS.clear()
ringe = Engine(store, device="cpu", device_threshold=0, mesh=mesh)
report["ring_answer"] = ringe.query_bytes(RING_Q).decode()
report["ring_programs"] = dict(M.PROGRAM_CALLS)
Executor.ring_threshold = 1 << 17
report["ring_host"] = host.query_bytes(RING_Q).decode()

# failures every rank sees: an allocation failure on rank 1 alone at a
# mesh hop's site is retried by both ranks; two in a row raise on both;
# a budget that runs out on rank 1 alone ends the request on both
from dgraph_tpu_torch.utils import memgov
from dgraph_tpu_torch.utils.deadline import DeadlineExceeded

def faults(site, n, ranks=(1,)):
    # the hook of `ranks`: the next n launches at `site` fail
    left = [n if rank in ranks else 0]
    def hook(at):
        if at == site and left[0]:
            left[0] -= 1
            return True
        return False
    memgov.set_alloc_fault(hook)

def attempt(run):
    t0 = time.monotonic()
    try:
        got = {"answer": run()}
    except Exception as e:
        f = M.failure_of(e)
        got = {"raised": type(e).__name__, "message": str(e),
               "stage": getattr(e, "stage", None),
               "agreed": None if f is None else f.kind}
    got["seconds"] = time.monotonic() - t0
    return got

retry = {}
one4 = M.make_mesh(devices=["cpu"] * 4)
for site, ring in (("mesh.matrix_hop", 1 << 17), ("mesh.ring_matrix_hop", 4)):
    Executor.ring_threshold = ring
    e0 = METRICS.get("oom_events_total", site=site)
    faults(site, 1)
    retry[site] = attempt(lambda: ringe.query_bytes(RING_Q).decode())
    retry[site]["oom_events"] = METRICS.get("oom_events_total",
                                            site=site) - e0
    memgov.set_alloc_fault(None)
    retry[site]["one_process"] = Engine(
        store, device="cpu", device_threshold=0,
        mesh=one4).query_bytes(RING_Q).decode()
Executor.ring_threshold = 1 << 17
report["retry"] = retry
faults("mesh.matrix_hop", 2)
report["double"] = attempt(lambda: ringe.query_bytes(RING_Q).decode())
memgov.set_alloc_fault(None)
report["double"]["next"] = ringe.query_bytes(RING_Q).decode()
alpha.device_threshold = 0
report["expiry"] = attempt(lambda: alpha.query_raw(
    QUERIES[0], deadline_ms=1e-3 if rank == 1 else None).decode())
report["expiry"]["next"] = alpha.query_raw(QUERIES[0]).decode()

def together(*runs):
    # each run on a thread of its own, started in order 0.3 s apart
    got = [None] * len(runs)
    threads = []
    for i, run in enumerate(runs):
        t = threading.Thread(
            target=lambda i=i, run=run: got.__setitem__(i, attempt(run)))
        t.start()
        threads.append(t)
        time.sleep(0.3)
    for t in threads:
        t.join(120)
    return got

# two distinct reads never sent before, started on the two ranks in
# opposite orders: each rank's agreement keys depend on the request only
A = "{ q(func: uid(0x2)) { name friend { name } } }"
B = "{ q(func: uid(0x3)) { name friend { name } } }"
order = (A, B) if rank == 0 else (B, A)
got = together(*(lambda q=q: alpha.query_raw(q).decode() for q in order))
report["opposite"] = {"got": dict(zip(order, got)), "host": {
    q: host.query_bytes(q).decode() for q in (A, B)}}

# an upsert whose query block rides the mesh: two allocation failures on
# rank 1 in its mesh route raise on both ranks; then one whose budget is
# out on rank 1 alone before its first round, while rank 0 goes on into
# its collectives and a read follows on each rank: rank 0's write ends at
# the round rank 1's read meets, and the read is served on both
UPSERT = ('upsert { query { q(func: has(friend), first: 40) '
          '{ v as friend (orderasc: name) { name } } } '
          'mutation { set { uid(v) <name> "renamed" . } } }')
faults("mesh.matrix_hop", 2)
report["write_alloc"] = attempt(lambda: alpha.upsert(UPSERT))
memgov.set_alloc_fault(None)
report["write_alloc"]["next"] = alpha.query_raw(QUERIES[0]).decode()
w, r = together(lambda: alpha.upsert(
    UPSERT, deadline_ms=1e-3 if rank == 1 else None),
    lambda: alpha.query_raw(QUERIES[0]).decode())
report["write_behind"] = {"write": w, "read": r}

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

# two different programs on the two ranks: both raise at the first
# round, naming both, and no operand moves
c0 = dict(M.CROSS_CALLS)
srel = store.sharded_rel("friend", False, mesh)
report["mismatch"] = attempt(
    lambda: dhop.matrix_hop(mesh, srel, fr, 512) if rank == 0 else
    dhop.scatter_gather_hop(mesh, srel, fr, 512, 512))
report["mismatch"]["calls"] = {k: v - c0.get(k, 0)
                               for k, v in M.CROSS_CALLS.items()
                               if v != c0.get(k, 0)}

# a mesh of this process's own shards inside the group: no cross-process
# call, whatever it serves
local = M.make_mesh(devices=["cpu", "cpu"])
before = dict(M.CROSS_CALLS)
M.PROGRAM_CALLS.clear()
loce = Engine(worker_store(StoreBuilder, parse_schema), device="cpu",
              device_threshold=0, mesh=local)
report["local_answers"] = [loce.query_bytes(q).decode() for q in QUERIES]
report["local_programs"] = dict(M.PROGRAM_CALLS)
# and so does an Alpha over it, with admission armed
loca = Alpha(base=worker_store(StoreBuilder, parse_schema), device="cpu",
             device_threshold=0, mesh=local)
loca.attach_admission(2, 2)
report["local_alpha_answers"] = [loca.query_raw(q).decode()
                                 for q in QUERIES]
loca.query_batch(SMALL)
# an allocation failure on a one-process mesh is retried here alone
e0 = METRICS.get("oom_events_total", site="mesh.matrix_hop")
faults("mesh.matrix_hop", 1, ranks=(0, 1))
report["local_retry_answer"] = loca.query_raw(RING_Q).decode()
memgov.set_alloc_fault(None)
report["local_retry_events"] = METRICS.get(
    "oom_events_total", site="mesh.matrix_hop") - e0
report["local_cross_calls"] = {k: v - before.get(k, 0)
                               for k, v in M.CROSS_CALLS.items()
                               if v != before.get(k, 0)}
save()
M.shutdown_distributed()
""" % (QUERIES, RING_Q)

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
""" % (QUERIES + (RING_Q,),)

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

# an allocation failure on rank 1 alone at the knn and feat sites is
# retried by both ranks; a failure in a launch after its program's last
# collective is seen by both
from dgraph_tpu_torch.utils import costprofile, memgov
from dgraph_tpu_torch.utils.metrics import METRICS
cases = dict(program_cases(mesh))

def fail_once(site):
    left = [int(rank == 1)]
    def hook(at):
        if at == site and left[0]:
            left[0] -= 1
            return True
        return False
    return hook

retried, report["retry"] = {}, {}
for site, name in (("vec.topk", "knn_mesh"), ("feat.agg", "feat_mesh_sum")):
    e0 = METRICS.get("oom_events_total", site=site)
    memgov.set_alloc_fault(fail_once(site))
    for i, a in enumerate(host_outputs(cases[name]())):
        retried[f"{name}/{i}"] = a
    memgov.set_alloc_fault(None)
    report["retry"][site] = {"program": name, "oom_events": METRICS.get(
        "oom_events_total", site=site) - e0}
np.savez(os.path.join(out_dir, f"retried.{rank}.npz"), **retried)
plain_note = costprofile.note_launch
armed = [rank == 1]

def late_failure(t0, t1):
    if armed[0]:
        armed[0] = False
        raise ValueError("a launch failed after its last collective")
    return plain_note(t0, t1)

costprofile.note_launch = late_failure
try:
    cases["knn_mesh"]()
    report["after_last"] = {"raised": None}
except Exception as e:
    report["after_last"] = {"raised": type(e).__name__, "message": str(e),
                            "agreed": M.failure_of(e).kind}
costprofile.note_launch = plain_note
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
    retried = [dict(np.load(tmp / f"retried.{r}.npz")) for r in range(2)]
    return reports, outs, retried


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
    relation equals device_put_rel on its shards, agreed by one gather
    (with its one status round: a gather's own scope needs no closing
    round), and the hop
    over a frontier spanning both processes' rows is the CSR walk."""
    reports, _outs, _retried = program_runs
    for r in reports:
        assert r["disjoint"] and r["assembled_equal"]
        assert r["assemble_calls"] == {"nnz": 1, "status": 1}
        assert r["sharded_hop_equal"] and r["sharded_hop_edges"] > 0


# -- (b) every program across processes ---------------------------------------------

@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_program_across_processes_equals_one_process(
        name, program_runs, single_process_programs):
    reports, outs, _retried = program_runs
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
    lane kernel is a lane kernel on both ranks: the lead's answer, agreed
    once for the batch, forms the groups while the mesh spans
    processes."""
    port, _ref = query_runs
    assert port[0]["prior_worth"] and not port[1]["prior_worth"]
    for r in port:
        assert r["batch_answers"] == r["batch_host"]
        assert r["batch_kernel_groups"] >= 1
        assert r["batch_programs"] == {}, r["batch_programs"]
        assert r["batch_agree"] == 1
    assert port[0]["batch_answers"] == port[1]["batch_answers"]


def test_fully_local_mesh_in_a_group_makes_no_cross_process_call(
        query_runs):
    """Neither its engine, nor an Alpha over it with admission armed,
    nor a batch, nor an allocation failure its retry absorbs here alone:
    no collective, no status round and no agreement."""
    port, _ref = query_runs
    for r in port:
        assert r["local_cross_calls"] == {}
        assert "status" not in r["local_cross_calls"]
        assert r["local_programs"].get("matrix_level")
        assert r["local_answers"] == r["host_answers"]
        assert r["local_alpha_answers"] == r["host_answers"]
        assert r["local_retry_answer"] == r["ring_host"]
        assert r["local_retry_events"] == 1


# -- failures every rank sees ------------------------------------------------------

@pytest.mark.parametrize("site", ["mesh.matrix_hop", "mesh.ring_matrix_hop",
                                  "vec.topk", "feat.agg"])
def test_one_rank_allocation_failure_is_retried_by_every_rank(
        site, query_runs, program_runs, single_process_programs):
    """An allocation failure on rank 1 alone at each mesh site: both ranks
    evict and run the attempt again, the answers equal the reference's
    two-process answer and the one-process 4-shard mesh's, and only rank
    1 counts the event."""
    port, ref = query_runs
    reports, _outs, retried = program_runs
    if site.startswith("mesh."):
        got = [r["retry"][site] for r in port]
        for g in got:
            assert g.get("answer") == ref[0][len(QUERIES)] == \
                ref[1][len(QUERIES)] == g["one_process"], g
            assert g["seconds"] < 10
    else:
        got = [r["retry"][site] for r in reports]
        name = got[0]["program"]
        want = single_process_programs[name]
        for r in range(2):
            for i, a in enumerate(want):
                assert a.tobytes() == retried[r][f"{name}/{i}"].tobytes()
    assert [g["oom_events"] for g in got] == [0, 1]


def test_two_allocation_failures_raise_on_both_ranks(query_runs):
    """Two failures in a row on rank 1: both ranks raise the allocation
    error's class well inside the group's timeout, and the next query is
    served on both, equal to the reference's."""
    port, ref = query_runs
    for r in port:
        d = r["double"]
        assert d.get("raised") == "AllocFault" and d["agreed"] == "alloc", d
        assert d["seconds"] < 10
        assert d["next"] == ref[0][len(QUERIES)]
    assert "rank 1 failed at mesh.matrix_hop" in port[0]["double"]["message"]


def test_budget_out_on_one_rank_ends_the_request_on_both(query_runs):
    """A read whose budget runs out on rank 1 alone (rank 0 has none):
    both ranks raise DeadlineExceeded naming the same stage, in under
    10 s with a group timeout of GROUP_TIMEOUT_S, and the next request is
    served on both."""
    port, ref = query_runs
    got = [r["expiry"] for r in port]
    for g in got:
        assert g.get("raised") == "DeadlineExceeded", g
        assert g["seconds"] < 10 < GROUP_TIMEOUT_S
        assert g["next"] == ref[0][0]
    assert got[0]["stage"] == got[1]["stage"] and got[0]["stage"]
    assert got[0]["agreed"] == "deadline"


def test_distinct_reads_in_opposite_orders_are_served_on_both(query_runs):
    """Two reads new to both ranks, started on rank 0 in one order and on
    rank 1 in the other: both are served on both, each the host
    engine's answer (an agreement key depends on its request alone)."""
    port, _ref = query_runs
    for r in port:
        o = r["opposite"]
        for q, got in o["got"].items():
            assert got.get("answer") == o["host"][q], (q, got)
            assert got["seconds"] < 10


@pytest.mark.parametrize("case", ["write_alloc", "write_behind"])
def test_write_failing_on_one_rank_leaves_the_next_read_served(
        case, query_runs):
    """An upsert whose query block rides the mesh fails on rank 1 alone:
    two allocation failures in its mesh route raise AllocFault on both
    ranks; a budget out before its first round ends rank 1's write
    there, and rank 0's at the round where rank 1's next read meets it
    (the ranks ahead meet that round again). Either way no write is
    applied, and the next read is served on both, equal to the
    reference's, well inside the group's timeout."""
    port, ref = query_runs
    if case == "write_alloc":
        for r in port:
            w = r["write_alloc"]
            assert w.get("raised") == "AllocFault" and \
                w["agreed"] == "alloc", w
            assert w["seconds"] < 10
            assert w["next"] == ref[0][0]
        return
    writes = [r["write_behind"]["write"] for r in port]
    assert writes[1].get("raised") == "DeadlineExceeded", writes
    assert writes[0].get("raised") == "MeshFailure", writes
    assert writes[0]["agreed"] == "behind"
    assert "have left request" in writes[0]["message"]
    for r in port:
        read = r["write_behind"]["read"]
        assert read.get("answer") == ref[0][0], read
        assert read["seconds"] < 10 < GROUP_TIMEOUT_S


def test_different_programs_raise_on_both_ranks_and_fold_nothing(
        query_runs):
    """Rank 0 drives matrix_hop while rank 1 drives scatter_gather_hop:
    the first status round finds two identities, both ranks raise naming
    both, and no operand crosses."""
    port, _ref = query_runs
    for r in port:
        m = r["mismatch"]
        assert m.get("raised") == "MeshFailure" and m["agreed"] == "mismatch"
        assert "rank 0 at matrix_hop" in m["message"]
        assert "rank 1 at scatter_gather_hop" in m["message"]
        assert m["calls"] == {"status": 1}
    assert port[0]["mismatch"]["message"] == port[1]["mismatch"]["message"]


def test_failure_after_the_last_collective_is_seen_by_both(program_runs):
    """A launch that fails on rank 1 after its program's last collective:
    the attempt's closing round tells rank 0, which raises naming rank 1;
    rank 1 raises its own error."""
    reports, _outs, _retried = program_runs
    late = [r["after_last"] for r in reports]
    assert late[1]["raised"] == "ValueError"
    assert late[0]["raised"] == "MeshFailure"
    assert "rank 1 failed" in late[0]["message"]
    assert "after its last collective" in late[0]["message"]
    assert late[0]["agreed"] == late[1]["agreed"] == "error"


def test_decision_store_and_occurrences_stay_bounded(monkeypatch):
    """10,000 distinct agreements through a loopback store leave no
    decision in it (each is deleted by its one follower's read) and no
    occurrence entry (one lives only while a thread agrees under its
    key). Identical requests share a key and take it in turns: the
    lead's second decision under a key waits until the follower has read
    the first, so the follower reads each in order, never a stale one."""
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=5),
        wait_for_workers=False)
    monkeypatch.setattr(pmesh, "_DECISIONS", store)
    monkeypatch.setattr(pmesh, "_OCCURRENCES", {})
    lead = pmesh.Mesh(["cpu"] * 4, ranks=(0, 0, 1, 1), rank=0)
    follower = pmesh.Mesh(["cpu"] * 4, ranks=(0, 0, 1, 1), rank=1)
    most = 0
    for i in range(10_000):
        key = pmesh.agree_key("request", "read", i)
        pmesh.agree(lead, key, {"turn": i})
        most = max(most, store.num_keys())
        assert pmesh.agree(follower, key) == {"turn": i}
    assert most == 1 and store.num_keys() == 0
    assert pmesh._OCCURRENCES == {}
    key = pmesh.agree_key("request", "a")
    assert key == pmesh.agree_key("request", "a") != pmesh.agree_key(
        "request", "b")
    pmesh.agree(lead, key, "first")         # its follower reads it late
    second = threading.Thread(target=pmesh.agree, args=(lead, key, "second"))
    second.start()
    time.sleep(0.3)
    assert second.is_alive()        # waits until the first is read
    assert pmesh.agree(follower, key) == "first"
    second.join(10)
    assert not second.is_alive()
    assert pmesh.agree(follower, key) == "second"
    assert store.num_keys() == 0 and pmesh._OCCURRENCES == {}


def _same_on_both(port, key, step):
    a, b = (r[key][step] for r in port)
    assert a == b, (key, step, a, b)
    return a


@pytest.mark.parametrize("step,holder", [("held_0", 0), ("free", None),
                                         ("held_1", 1)])
def test_admission_follows_the_lead_whichever_lane_is_held(
        step, holder, query_runs):
    """One token, no queue: with rank 0's token held the request is shed
    on both ranks with the lead's Retry-After; free, it is served on
    both; with rank 1's token held rank 1 serves it anyway. Every served
    answer is the reference's two-process answer."""
    port, ref = query_runs
    got = _same_on_both(port, "admission", step)
    if holder == 0:
        assert got["shed"] == "queue_full" and got["retry_after_s"] > 0
    else:
        assert got == {"served": ref[0][0]}
    for r in port:
        # the local holds and the lead's verdicts, counted alike
        assert r["admission"]["lane"] == {"admitted_total": 3,
                                          "shed_total": 1}


def test_forecast_shedding_is_decided_by_the_lead_alone(query_runs):
    """A forecast that says shed sheds on both ranks when the lead's says
    so (both count a forecast shed), and nowhere when only a follower's
    says so."""
    port, ref = query_runs
    lead = _same_on_both(port, "forecast", "lead")
    assert lead["shed"] == "forecast" and lead["retry_after_s"] > 0
    assert _same_on_both(port, "forecast", "follower") == {
        "served": ref[0][1]}
    for r in port:
        assert r["forecast"]["forecast_sheds"] == 1


def test_displaced_waiter_is_shed_on_both_ranks(query_runs):
    """The lead's queued expensive request, displaced by a cheaper one,
    is shed on both ranks with the lead's hint; the cheaper one is
    served on both."""
    port, ref = query_runs
    a = _same_on_both(port, "displaced", "a")
    assert a["shed"] == "displaced" and a["retry_after_s"] > 0
    assert _same_on_both(port, "displaced", "b") == {"served": ref[0][2]}
    assert port[0]["displaced"]["lane"] == {"admitted_total": 2,
                                            "shed_total": 1}
    assert port[1]["displaced"]["lane"] == {"admitted_total": 1,
                                            "shed_total": 1}


def test_route_promotion_follows_rank_0s_priors(query_runs):
    """Under a device_threshold no frontier reaches, rank 0's route EMAs
    promote the mesh and rank 1's do not: the request takes the mesh on
    both ranks, with equal mesh_route_total counts. Outside a granted
    request neither rank's own EMAs choose the mesh."""
    port, ref = query_runs
    assert port[0]["own_promotion"] and not port[1]["own_promotion"]
    routes = [r["promoted_routes"] for r in port]
    assert routes[0] == routes[1] and routes[0]["mesh"] >= 1, routes
    assert _same_on_both(port, "promoted_answer", "served") == ref[0][3]
    for r in port:
        assert r["ungranted_routes"]["mesh"] == 0
        assert r["ungranted_routes"]["numpy"] >= 1
        assert r["ungranted_answer"] == ref[0][3]


def test_each_alpha_request_agrees_once(query_runs):
    """One store round trip per request on each rank, whatever the
    verdict."""
    port, _ref = query_runs
    for r in port:
        assert r["alpha_agree"] == r["alpha_requests"] == 8


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


def test_follower_without_a_decision_raises_naming_the_key(monkeypatch):
    """A follower that cannot read the lead's decision raises within the
    store's timeout, naming the key; it never decides for itself."""
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, 1, True, timeout=datetime.timedelta(seconds=1),
        wait_for_workers=False)
    monkeypatch.setattr(pmesh, "_DECISIONS", store)
    lead = pmesh.Mesh(["cpu"] * 4, ranks=(0, 0, 1, 1), rank=0)
    follower = pmesh.Mesh(["cpu"] * 4, ranks=(0, 0, 1, 1), rank=1)
    assert lead.is_lead and not follower.is_lead
    before = pmesh.CROSS_CALLS.get("agree", 0)
    assert pmesh.agree(lead, "request/k/0", {"turn": 0}) == {"turn": 0}
    assert pmesh.agree(follower, "request/k/0") == {"turn": 0}
    assert pmesh.CROSS_CALLS["agree"] == before + 2
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="under key 'request/k/1'"):
        pmesh.agree(follower, "request/k/1")
    assert time.monotonic() - t0 < 10
    assert pmesh.CROSS_CALLS["agree"] == before + 2


def test_one_process_alphas_make_no_agree_call():
    """An Alpha without a mesh and one over a one-process mesh serve with
    admission armed, and retry an allocation failure, and never agree
    nor make a status round."""
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder
    from dgraph_tpu_torch.utils import memgov
    ns = {"np": np}
    exec(STORE_SRC, ns)
    before = dict(pmesh.CROSS_CALLS)
    for mesh in (None, pmesh.make_mesh(2, device="cpu")):
        a = Alpha(base=ns["worker_store"](StoreBuilder, parse_schema),
                  device="cpu", device_threshold=0, mesh=mesh)
        a.attach_admission(2, 2)
        assert a.query(QUERIES[0])["q"]
        fired = []

        def once(at):
            # the first launch of the ordered level's expansion fails
            if at in ("mesh.matrix_hop", "hop.gather_edges") and not fired:
                fired.append(at)
                return True
            return False

        memgov.set_alloc_fault(once)
        try:
            assert a.query(RING_Q)["q"]
        finally:
            memgov.set_alloc_fault(None)
        assert fired
    assert pmesh.CROSS_CALLS == before


def test_turns_run_in_grant_order():
    """A later turn waits for the earlier one to end; a turn whose
    predecessor never comes raises within its timeout."""
    from dgraph_tpu_torch.server.api import _Turns
    turns = _Turns()
    assert [turns.grant() for _ in range(3)] == [0, 1, 2]
    ran = []

    def second():
        with turns.turn(1, 30):
            ran.append(1)

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.2)
    assert ran == []
    with turns.turn(0, 30):
        ran.append(0)
    t.join(30)
    assert ran == [0, 1]
    with pytest.raises(RuntimeError, match="turn 2 has not ended"):
        with turns.turn(4, 0.2):
            pass


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
                     "--max_inflight", "2", "--queue_depth", "2",
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
        assert "admission control armed: max_inflight=2" in t, t[-3000:]
        assert "draining maintenance" in t


def test_collective_sites_are_the_mesh_modules_only():
    """The facts inventory lists every torch.distributed call, and every
    one lies in parallel/mesh.py: the group, the mesh's shape exchange,
    the cross-process gathers and the store of the lead's decisions
    (graftlint R7 keeps them there)."""
    from dgraph_tpu_torch.analysis import run
    sites = run().facts["collective_sites"]
    assert {s["file"] for s in sites} == {"dgraph_tpu_torch/parallel/mesh.py"}
    assert {"init_process_group", "new_group", "all_gather_object",
            "all_gather", "destroy_process_group", "rendezvous",
            "PrefixStore", "store.set", "store.get"} <= {s["call"]
                                                         for s in sites}
    assert not {"all_reduce", "reduce_scatter", "broadcast"} & {
        s["call"] for s in sites}
