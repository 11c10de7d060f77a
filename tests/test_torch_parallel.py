"""The port's mesh programs against the reference's, on eight shards.

The reference runs on JAX's 8 virtual CPU devices (tests/conftest.py),
the port on `make_mesh(8, device="cpu")`: the same seeded numpy inputs
go through `parallel/{pshard,dhop,dsort,dbfs}.py` and `ops/bfs.py`'s COO
bitmap hop of both packages, and every output, `needs` vector, count
and edge total must be equal exactly (all of it is integer work; the
sort keys are the same float64 values on both sides of each compare).
The second half runs every case of the reference's `test_parallel.py`
and `test_dbfs.py` on the port through the lifecycle harness
(`test_torch_lifecycle.py`), with `make_mesh` bound to the CPU shards
and the COO recurse to the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import test_dbfs
import test_parallel
from test_parallel import pad, random_csr
from test_torch_lifecycle import (PORT, REF, reference_cases,
                                  run_reference_case)

from dgraph_tpu.models.synthetic import powerlaw_rel, uniform_rel
from dgraph_tpu.ops import bfs as ref_bfs
from dgraph_tpu.parallel import dbfs as ref_dbfs
from dgraph_tpu.parallel import dhop as ref_dhop
from dgraph_tpu.parallel import dsort as ref_dsort
from dgraph_tpu.parallel import mesh as ref_mesh
from dgraph_tpu.parallel import pshard as ref_pshard
from dgraph_tpu.store.schema import parse_schema as ref_parse_schema
from dgraph_tpu.store.store import StoreBuilder as RefBuilder
from dgraph_tpu_torch.ops import bfs as port_bfs
from dgraph_tpu_torch.parallel import dbfs, dhop, dsort, mesh, pshard
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import EdgeRel, StoreBuilder

torch.set_num_threads(1)
N = 503


def _equal(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for i, (a, b) in enumerate(zip(ref_out, port_out)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")


@pytest.fixture(scope="module")
def meshes():
    return ref_mesh.make_mesh(8), mesh.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def rels(meshes):
    g = random_csr(n=N, avg_deg=7, seed=0)
    port_g = EdgeRel(indptr=g.indptr, indices=g.indices)
    return (ref_pshard.device_put_rel(ref_pshard.shard_rel(g, 8), meshes[0]),
            pshard.device_put_rel(pshard.shard_rel(port_g, 8), meshes[1]))


def _frontier(n, seed):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, N, n)).astype(np.int32)


FR = _frontier(100, 1)
CHUNKS = ref_pshard.shard_frontier(FR, 8, 32)
ALLOWED = pad(np.arange(0, N, 3, dtype=np.int32), 256)
SEEDS2 = pad(np.array([3, 77], np.int32), 1024)
SEEDS20 = pad(np.arange(20, dtype=np.int32), 32)
SEEN2 = pad(np.array([3, 77], np.int32), 2048)

# (program, its arguments after (mesh, rel)): overflowing caps included,
# so the `needs` / max-edge witnesses are held too
PROGRAMS = {
    "scatter_gather": ("scatter_gather_hop", (pad(FR, 128), 4096, 1024)),
    "scatter_gather_overflow": ("scatter_gather_hop",
                                (pad(FR, 128), 16, 32)),
    "scatter_gather_one": ("scatter_gather_hop",
                           (pad(FR[:1], 64), 4096, 1024)),
    "matrix": ("matrix_hop", (pad(FR, 128), 512)),
    "matrix_overflow": ("matrix_hop", (pad(FR, 128), 8)),
    "level_all": ("matrix_level", (pad(FR, 128), ALLOWED, 0, 1 << 30, 512,
                                   True)),
    "level_page": ("matrix_level", (pad(FR, 128), ALLOWED, 1, 2, 512, True)),
    "level_last": ("matrix_level", (pad(FR, 128), ALLOWED, 0, -2, 512,
                                    True)),
    "level_unfiltered": ("matrix_level", (pad(FR, 128), pad(FR[:0], 1), 2,
                                          3, 512, False)),
    "ring": ("ring_hop", (CHUNKS, 4096, 1024)),
    "ring_overflow": ("ring_hop", (CHUNKS, 8, 32)),
    "ring_matrix": ("ring_matrix_hop", (CHUNKS, 128)),
    "recurse": ("recurse_fused", (SEEDS2, 8192, 1024, 2048, 3)),
    "recurse_overflow": ("recurse_fused", (SEEDS20, 4096, 32, 64, 2)),
    "recurse_matrix": ("recurse_fused_matrix", (SEEDS2, 8192, 1024, 2048,
                                                3)),
    "recurse_matrix_overflow": ("recurse_fused_matrix",
                                (SEEDS20, 64, 32, 64, 2)),
    "chain": ("chain_hop", (SEEDS2, SEEN2, 8192, 1024, 2048)),
    "chain_overflow": ("chain_hop", (SEEDS20, pad(SEEDS20[:20], 64), 16,
                                     32, 64)),
}


@pytest.mark.parametrize("case", sorted(PROGRAMS))
def test_dhop_program_matches_reference(case, meshes, rels):
    name, args = PROGRAMS[case]
    ref = getattr(ref_dhop, name)(meshes[0], rels[0], *args)
    port = getattr(dhop, name)(meshes[1], rels[1], *args)
    _equal(ref, port)


@pytest.mark.parametrize("n_shards", [1, 3, 8, 13])
@pytest.mark.parametrize("graph", ["random", "powerlaw", "empty_rows"])
def test_shard_rel_matches_reference(graph, n_shards):
    if graph == "random":
        g = random_csr(n=N, avg_deg=7, seed=2)
    elif graph == "powerlaw":
        g = powerlaw_rel(300, 5.0, seed=4)
    else:
        g = random_csr(n=40, avg_deg=1, seed=5)
    ref = ref_pshard.shard_rel(g, n_shards)
    port = pshard.shard_rel(EdgeRel(indptr=g.indptr, indices=g.indices),
                            n_shards)
    _equal((ref.indptr_s, ref.indices_s, ref.row_lo, ref.pos_lo),
           (port.indptr_s, port.indices_s, port.row_lo, port.pos_lo))
    assert (ref.n_nodes, ref.n_shards, ref.rows_per_shard) == \
        (port.n_nodes, port.n_shards, port.rows_per_shard)


def test_assemble_sharded_rel_from_local_slabs():
    """The per-shard slabs of `shard_rel`, assembled, give the placed
    relation `device_put_rel` gives (one process holds every shard); a
    slab missing for a shard this process owns raises
    (`test_torch_multihost.py` assembles slabs held by two processes)."""
    g = random_csr(n=N, avg_deg=7, seed=2)
    host = pshard.shard_rel(EdgeRel(indptr=g.indptr, indices=g.indices), 8)
    m = mesh.make_mesh(8, device="cpu")
    slabs = {d: (host.indptr_s[d], host.indices_s[d, :host.indptr_s[d, -1]])
             for d in range(8)}
    got = pshard.assemble_sharded_rel(m, N, slabs)
    want = pshard.device_put_rel(host, m)
    _equal((want.indptr_s, want.indices_s, want.row_lo, want.pos_lo),
           (got.indptr_s, got.indices_s, got.row_lo, got.pos_lo))
    del slabs[3]
    with pytest.raises(ValueError, match=r"owns shards \[0, 1, 2, 3, 4, "
                       r"5, 6, 7\] of the mesh and was given slabs "
                       r"\[0, 1, 2, 4, 5, 6, 7\]"):
        pshard.assemble_sharded_rel(m, N, slabs)


@pytest.mark.parametrize("n", [0, 5, 120])
def test_shard_frontier_matches_reference(n):
    fr = _frontier(n, 3) if n else np.zeros(0, np.int32)
    np.testing.assert_array_equal(ref_pshard.shard_frontier(fr, 8, 32),
                                  pshard.shard_frontier(fr, 8, 32))


# -- order-by on the mesh -----------------------------------------------------

def _sort_store(make, parse):
    rng = np.random.default_rng(5)
    b = make(parse("score: int @index(int) .\nheight: float .\n"
                      "born: datetime .\nname: string ."))
    for u in range(1, 501):
        b.add_value(u, "score", int(rng.integers(0, 10_000)))
        if u % 3:
            b.add_value(u, "height", float(rng.uniform(1.0, 2.0)))
        b.add_value(u, "born", f"19{50 + int(rng.integers(0, 50)):02d}"
                               f"-01-0{1 + u % 9}")
        b.add_value(u, "name", f"n{int(rng.integers(0, 300))}")
    return b.finalize()


@pytest.fixture(scope="module")
def sort_stores():
    return _sort_store(RefBuilder, ref_parse_schema), \
        _sort_store(StoreBuilder, parse_schema)


@pytest.mark.parametrize("k", [1, 5, 60, 1000])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("pred", ["score", "height", "born", "name"])
def test_mesh_topk_matches_reference(pred, desc, k, meshes, sort_stores):
    rng = np.random.default_rng(k + 7 * desc)
    ranks = np.unique(rng.integers(0, 500, 300)).astype(np.int32)
    ref = ref_dsort.mesh_topk(meshes[0], sort_stores[0], pred, "", ranks,
                              k, desc)
    port = dsort.mesh_topk(meshes[1], sort_stores[1], pred, "", ranks, k,
                           desc)
    np.testing.assert_array_equal(ref, port)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("pred", ["score", "height", "born", "name"])
def test_mesh_row_sort_matches_reference(pred, desc, meshes, sort_stores):
    rng = np.random.default_rng(11 + desc)
    nbrs = rng.integers(0, 500, 700).astype(np.int32)
    seg = np.sort(rng.integers(0, 50, 700)).astype(np.int32)
    ref = ref_dsort.mesh_row_sort(meshes[0], sort_stores[0], pred, "",
                                  nbrs, seg, desc)
    port = dsort.mesh_row_sort(meshes[1], sort_stores[1], pred, "", nbrs,
                               seg, desc)
    np.testing.assert_array_equal(ref, port)


# -- the COO bitmap hop and its sharded recurse ----------------------------------

GRAPHS = {"powerlaw": lambda: powerlaw_rel(500, 4.0, seed=11),
          "uniform": lambda: uniform_rel(257, 3, seed=5)}


def _coo(rel):
    deg = np.diff(rel.indptr).astype(np.int32)
    src = np.repeat(np.arange(len(deg), dtype=np.int32), deg)
    return src, rel.indices.astype(np.int32), deg


def _masks(n, B, seed):
    rng = np.random.default_rng(seed)
    seeds = [rng.integers(0, n, rng.integers(1, 5)) for _ in range(B)]
    return ref_bfs.ranks_to_bitmap(seeds, n), seeds


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bitmap_hop_and_helpers_match_reference(graph):
    rel = GRAPHS[graph]()
    n = rel.indptr.shape[0] - 1
    m0, seeds = _masks(n, 16, 3)
    np.testing.assert_array_equal(m0, port_bfs.ranks_to_bitmap(seeds, n))
    for a, b in zip(ref_bfs.bitmap_to_ranks(m0),
                    port_bfs.bitmap_to_ranks(m0)):
        np.testing.assert_array_equal(a, b)
    src, dst, _deg = _coo(rel)
    got = port_bfs.bitmap_hop(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(m0))
    np.testing.assert_array_equal(np.asarray(ref_bfs.bitmap_hop(src, dst,
                                                                m0)),
                                  got.numpy())


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bitmap_recurse_matches_reference(graph, depth):
    rel = GRAPHS[graph]()
    n = rel.indptr.shape[0] - 1
    m0, _ = _masks(n, 16, depth)
    src, dst, deg = _coo(rel)
    _equal(ref_bfs.bitmap_recurse(src, dst, deg, m0, depth=depth),
           port_bfs.bitmap_recurse(src, dst, deg, m0, depth=depth,
                                   device="cpu"))


@pytest.mark.parametrize("n_dev", [8, 3])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bitmap_recurse_sharded_matches_reference(graph, n_dev):
    rel = GRAPHS[graph]()
    n = rel.indptr.shape[0] - 1
    m0, _ = _masks(n, 16, n_dev)
    ref_parts = ref_dbfs.shard_coo_by_src(rel.indptr, rel.indices, n_dev)
    port_parts = dbfs.shard_coo_by_src(rel.indptr, rel.indices, n_dev)
    _equal(ref_parts[:3], port_parts[:3])
    assert ref_parts[3] == port_parts[3]
    slabs = ref_dbfs.shard_mask(m0, n_dev, ref_parts[3])
    np.testing.assert_array_equal(
        slabs, dbfs.shard_mask(m0, n_dev, port_parts[3]))
    ref = ref_dbfs.bitmap_recurse_sharded(ref_mesh.make_mesh(n_dev),
                                          *ref_parts[:3], slabs, 3)
    port = dbfs.bitmap_recurse_sharded(mesh.make_mesh(n_dev, device="cpu"),
                                       *port_parts[:3], slabs, 3)
    _equal(ref, port)
    np.testing.assert_array_equal(ref_dbfs.unshard_mask(np.asarray(ref[1]),
                                                        n),
                                  dbfs.unshard_mask(port[1], n))


def test_bitmap_recurse_sharded_refuses_past_int8_lane_sums():
    m = mesh.make_mesh(dbfs.MAX_SHARDS + 1, device="cpu")
    with pytest.raises(ValueError, match="127"):
        dbfs.bitmap_recurse_sharded(m, None, None, None, None, 1)


# -- the collectives and the placement ------------------------------------------

def test_collectives_on_shards_of_one_device():
    m = mesh.make_mesh(4, device="cpu")
    xs = [torch.full((2, 3), d, dtype=torch.int8) for d in range(4)]
    total = mesh.psum(m, xs)
    assert all(t is total[0] for t in total)      # one result per device
    assert total[0].dtype == torch.int8 and int(total[0][0, 0]) == 6
    assert int(mesh.pmax(m, xs)[2][1, 1]) == 3
    gathered = mesh.all_gather(m, xs)
    assert gathered[0].shape == (4, 2, 3) and int(gathered[3][2, 0, 0]) == 2
    rolled = mesh.ppermute(m, xs, [(i, (i + 1) % 4) for i in range(4)])
    assert [int(r[0, 0]) for r in rolled] == [3, 0, 1, 2]
    part = mesh.ppermute(m, xs, [(0, 1)])
    assert [int(r[0, 0]) for r in part] == [0, 0, 0, 0]
    big = [torch.arange(8, dtype=torch.int32).reshape(8, 1) * (d + 1)
           for d in range(4)]
    sc = mesh.psum_scatter(m, big, scatter_dimension=0, tiled=True)
    assert [s.flatten().tolist() for s in sc] == \
        [[0, 10], [20, 30], [40, 50], [60, 70]]
    rep = mesh.replicate(m, np.arange(5, dtype=np.int32))
    assert all(p is rep.parts[0] for p in rep.parts)
    np.testing.assert_array_equal(np.asarray(rep), np.arange(5))
    sh = mesh.device_put(np.arange(8).reshape(4, 2), mesh.shard_leading(m))
    assert isinstance(sh, mesh.Sharded) and sh.shape == (4, 2)
    np.testing.assert_array_equal(np.asarray(sh), np.arange(8).reshape(4, 2))


def test_make_mesh_devices_counts_and_refusals(monkeypatch):
    assert mesh.make_mesh(3, device="cpu").size == 3
    for var in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=r"127\.0\.0\.1:1 given without "
                       r"the number of processes .* and this process's "
                       r"rank"):
        mesh.init_distributed("127.0.0.1:1")
    with pytest.raises(ValueError, match=r"without this process's rank "
                       r"\(process_id, JAX_PROCESS_ID\)"):
        mesh.init_distributed("127.0.0.1:1", num_processes=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        mesh.make_mesh(2)
    four = mesh.make_mesh(devices=[torch.device("cuda", 0)] * 4)
    assert four.size == 4 and four.device_type == "cuda"
    assert set(four.devices) == {torch.device("cuda", 0)}
    with pytest.raises(ValueError, match="one device type"):
        mesh.Mesh([torch.device("cpu"), torch.device("cuda", 0)])


# -- the reference's own cases on the port ----------------------------------------

CPU_BINDINGS = {
    "dgraph_tpu.parallel.mesh": {
        "make_mesh": lambda n_devices=None, devices=None: mesh.make_mesh(
            n_devices, devices, device="cpu")},
    "dgraph_tpu.ops.bfs": {
        "bitmap_recurse": functools.partial(port_bfs.bitmap_recurse,
                                            device="cpu")},
}


def cpu_bindings(pkg, tr):
    """The names a reference case reaches for its devices, on the CPU
    for the port's run."""
    return CPU_BINDINGS if pkg == PORT else {}


def _expanded(module):
    """(module, case name, its parameters) for every case of `module`,
    a parametrized case once per parameter set."""
    out = []
    for name in reference_cases(module):
        marks = [m for m in getattr(getattr(module, name), "pytestmark", ())
                 if m.name == "parametrize"]
        sets = [{}]
        for mk in marks:
            keys = [k.strip() for k in mk.args[0].split(",")]
            vals = [v if len(keys) > 1 else (v,) for v in mk.args[1]]
            sets = [{**s, **dict(zip(keys, v))} for s in sets for v in vals]
        out += [(module, name, s) for s in sets]
    return out


CASES = _expanded(test_parallel) + _expanded(test_dbfs)


@pytest.mark.parametrize(
    "module,name,params", CASES,
    ids=[f"{m.__name__}::{n}" + "".join(f"-{v}" for v in p.values())
         for m, n, p in CASES])
def test_reference_mesh_case_on_port(module, name, params, tmp_path,
                                     monkeypatch):
    port = run_reference_case(module, name, PORT, tmp_path / "port",
                              monkeypatch, extra=cpu_bindings,
                              fixtures=params)
    ref = run_reference_case(module, name, REF, tmp_path / "ref",
                             monkeypatch, extra=cpu_bindings,
                             fixtures=params)
    assert port == ref


def test_case_list_covers_the_reference_modules():
    names = {n for m, n, p in CASES}
    assert {n for n in dir(test_parallel) if n.startswith("test_")} <= names
    assert {n for n in dir(test_dbfs) if n.startswith("test_")} <= names
