"""Port ELL layout, bucket hop and lane-packed @recurse == the JAX package.

Every input is made from a seed with numpy and handed to both packages;
the port runs with device="cpu" (the kernels' plain versions). All of
this is integer and bitmask work, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.models.synthetic import powerlaw_rel, uniform_rel
from dgraph_tpu.ops import bfs as ref_bfs
from dgraph_tpu.ops.pallas_hop import bucket_hop_pallas
from dgraph_tpu.store.store import _csr_from_pairs, _csr_from_pairs_np
from dgraph_tpu_torch.models import synthetic as port_synth
from dgraph_tpu_torch.ops import bfs as port_bfs
from dgraph_tpu_torch.ops.bucket_hop import bucket_hop, bucket_hop_plain
from dgraph_tpu_torch.store import store as port_store

CPU = "cpu"
# one intra-op thread: the suite runs files in parallel workers, and
# torch's default pool would compete with their timing-sensitive tests
torch.set_num_threads(1)


def _star():
    n = 600
    src = np.concatenate([np.arange(1, n), np.zeros(n - 1)])
    dst = np.concatenate([np.zeros(n - 1), np.arange(1, n)])
    return _csr_from_pairs(src.astype(np.int32), dst.astype(np.int32), n)


def _chain():
    n = 200
    return _csr_from_pairs(np.arange(n - 1, dtype=np.int32),
                           np.arange(1, n, dtype=np.int32), n)


def _degree_gap():
    src = np.arange(10, 50, dtype=np.int32)
    dst = np.repeat(np.arange(10, dtype=np.int32), 4)
    return _csr_from_pairs(src, dst, 64)


# the tests/test_bfs.py::TestSegmentCsr shapes
GRAPHS = {
    "powerlaw": lambda: powerlaw_rel(500, 8.0, seed=4),
    "star": _star,
    "chain": _chain,
    "all_heavy": lambda: uniform_rel(64, 48, seed=3),
    "degree_gap": _degree_gap,
}


def _seeds(n, B, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, rng.integers(1, 4)) for _ in range(B)]


def _numpy_bucket_hop(nbr, frontier):
    out = np.zeros((nbr.shape[0], frontier.shape[1]), np.uint32)
    for i in range(nbr.shape[0]):
        for k in range(nbr.shape[1]):
            out[i] |= frontier[nbr[i, k]]
    return out


def cpu_recurse(indptr, indices, seeds, depth):
    """bench.py's numpy loop=false walk for ONE query → edges traversed."""
    frontier = np.unique(seeds).astype(np.int64)
    seen_mask = np.zeros(indptr.shape[0] - 1, bool)
    seen_mask[frontier] = True
    edges = 0
    for _ in range(depth):
        if not len(frontier):
            break
        starts = indptr[frontier].astype(np.int64)
        deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        total = int(deg.sum())
        base = np.repeat(np.cumsum(deg) - deg, deg)
        pos = np.repeat(starts, deg) + (np.arange(total) - base)
        nbrs = indices[pos]
        edges += total
        nxt = np.unique(nbrs)
        nxt = nxt[~seen_mask[nxt]]
        seen_mask[nxt] = True
        frontier = nxt
    return edges


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_powerlaw_rel_and_csr_equal_reference():
    for n, deg, seed in ((500, 8.0, 4), (1 << 12, 16.0, 42)):
        a = powerlaw_rel(n, deg, seed=seed)
        b = port_synth.powerlaw_rel(n, deg, seed=seed)
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices, b.indices)
    rng = np.random.default_rng(1)
    src = rng.integers(0, 90, 700).astype(np.int32)
    dst = rng.integers(0, 90, 700).astype(np.int32)
    a = _csr_from_pairs_np(src, dst, 90)
    b = port_store._csr_from_pairs(src, dst, 90)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_ell_and_masks_equal_reference(name):
    rel = GRAPHS[name]()
    ref = ref_bfs.build_ell(rel.indptr, rel.indices)
    got = port_bfs.build_ell(rel.indptr, rel.indices)
    assert got.n == ref.n and got.seg_rows == ref.seg_rows
    assert got.ks == ref.ks
    assert len(got.parts) == len(ref.parts)
    for (k1, e1, r1), (k2, e2, r2) in zip(got.parts, ref.parts):
        assert (k1, r1) == (k2, r2)
        assert (e1 is None and e2 is None) or np.array_equal(e1, e2)
    assert (got.tiles is None) == (ref.tiles is None)
    if ref.tiles is not None:
        assert np.array_equal(got.tiles, ref.tiles)
    assert len(got.lvl2) == len(ref.lvl2)
    for a, b in zip(got.lvl2, ref.lvl2):
        assert np.array_equal(a, b)
    for f in ("outdeg", "perm_order", "new_of_old"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert got.padded_edges == ref.padded_edges

    seeds = _seeds(ref.n, 64, seed=3)
    m_ref = ref_bfs.pack_seed_masks(ref, seeds)
    m_got = port_bfs.pack_seed_masks(got, seeds)
    assert m_got.dtype == np.uint32 and np.array_equal(m_got, m_ref)
    dev_mask = port_bfs.put_mask(m_got, CPU)
    assert dev_mask.dtype == torch.int32
    for a, b in zip(port_bfs.unpack_masks(got, dev_mask),
                    ref_bfs.unpack_masks(ref, m_ref)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n_b,K,W", [(256, 1, 4), (256, 4, 4),
                                     (512, 16, 2), (256, 3, 1),
                                     (256, 8, 4), (256, 1024, 1)])
def test_bucket_hop_plain_equals_numpy_and_pallas(n_b, K, W):
    rng = np.random.default_rng(7)
    n = 1000
    nbr = rng.integers(0, n + 1, (n_b, K)).astype(np.int32)
    frontier = rng.integers(0, 2**32, (n + 1, W), dtype=np.uint32)
    frontier[n] = 0  # sentinel row
    want = _numpy_bucket_hop(nbr, frontier)
    pallas = np.asarray(bucket_hop_pallas(jnp.asarray(nbr),
                                          jnp.asarray(frontier)))
    assert np.array_equal(pallas, want)
    fr_t = torch.from_numpy(frontier.view(np.int32))
    nbr_t = torch.from_numpy(nbr)
    assert np.array_equal(_u32(bucket_hop_plain(nbr_t, fr_t)), want)
    # the wrapper takes the plain version for CPU tensors, and writes a
    # bucket into its row slice of a larger output
    out = torch.full((n_b + 5, W), -1, dtype=torch.int32)
    bucket_hop(nbr_t, fr_t, out, row0=3)
    got = _u32(out)
    assert np.array_equal(got[3:3 + n_b], want)
    assert (got[:3] == 0xFFFFFFFF).all() and (got[3 + n_b:] == 0xFFFFFFFF).all()


def test_bucket_hop_rejects_bad_inputs():
    fr = torch.zeros((9, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        bucket_hop(torch.zeros((2, 3), dtype=torch.int64), fr)
    with pytest.raises(ValueError):
        bucket_hop(torch.zeros((2, 3), dtype=torch.int32), fr,
                   torch.zeros((2, 4), dtype=torch.int32), row0=1)
    with pytest.raises(ValueError):
        bucket_hop(torch.zeros((2, 3), dtype=torch.int32), fr.t())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ell_hop_equals_reference_chain(name):
    """One full hop (every bucket, tiles and lvl2 included) == the
    reference's _ell_hop over its XLA gather chains."""
    rel = GRAPHS[name]()
    g = port_bfs.build_ell(rel.indptr, rel.indices)
    rng = np.random.default_rng(11)
    W = 3
    fr = rng.integers(0, 2**32, (g.n + 1, W), dtype=np.uint32)
    fr[g.n] = 0
    ref_prep = ref_bfs.prepare_parts(ref_bfs.device_ell(g), W)
    want = np.asarray(ref_bfs._ell_hop(ref_prep, jnp.asarray(fr), W))
    prep = port_bfs.prepare_parts(port_bfs.device_ell(g, CPU))
    got = port_bfs._ell_hop(prep, torch.from_numpy(fr.view(np.int32)))
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_make_ell_recurse_equals_reference(name):
    rel = GRAPHS[name]()
    g = port_bfs.build_ell(rel.indptr, rel.indices)
    seeds = _seeds(g.n, 64, seed=5)
    mask0 = port_bfs.pack_seed_masks(g, seeds)
    W = mask0.shape[1]
    ref_fn = ref_bfs.make_ell_recurse(ref_bfs.device_ell(g), g.outdeg,
                                      g.n, W)
    dev = port_bfs.device_ell(g, CPU)
    fn = port_bfs.make_ell_recurse(dev, g.outdeg, g.n, W)
    fn_nc = port_bfs.make_ell_recurse(dev, g.outdeg, g.n, W,
                                      count_edges=False)
    count = port_bfs.make_ell_count(g.outdeg, g.n, CPU)
    for depth in (1, 2, 3, 4):
        r_last, r_seen, r_edges, r_hops = ref_fn(jax.device_put(mask0),
                                                 depth, True)
        last, seen, edges, hops = fn(port_bfs.put_mask(mask0, CPU),
                                     depth, True)
        assert np.array_equal(_u32(last), np.asarray(r_last))
        assert np.array_equal(_u32(seen), np.asarray(r_seen))
        assert np.array_equal(_u32(hops), np.asarray(r_hops))
        assert edges.dtype == torch.int64
        assert np.array_equal(edges.numpy(), np.asarray(r_edges))
        want = [cpu_recurse(rel.indptr, rel.indices, s, depth)
                for s in seeds]
        assert edges.numpy().tolist() == want
        # the bench form: no in-run counter, one post-hoc count
        last2, seen2, zero = fn_nc(port_bfs.put_mask(mask0, CPU), depth)
        assert not zero.any()
        assert count(last2, seen2).numpy().tolist() == want
        for a, b in zip(port_bfs.unpack_masks(g, seen2),
                        ref_bfs.unpack_masks(g, np.asarray(r_seen))):
            assert np.array_equal(a, b)


def test_seed_mask_is_donated_and_checked():
    rel = GRAPHS["powerlaw"]()
    g = port_bfs.build_ell(rel.indptr, rel.indices)
    mask0 = port_bfs.pack_seed_masks(g, _seeds(g.n, 32, seed=9))
    fn = port_bfs.make_ell_recurse(port_bfs.device_ell(g, CPU), g.outdeg,
                                   g.n, 1)
    m = port_bfs.put_mask(mask0, CPU)
    _last, seen, _e = fn(m, 2)
    assert seen is m, "the seed mask becomes the seen carry"
    with pytest.raises(ValueError):
        fn(torch.zeros((g.n, 1), dtype=torch.int32), 2)
    bad = port_bfs.build_ell(rel.indptr, rel.indices)
    bad.tiles = bad.tiles.copy()
    bad.tiles[0, 0] = g.n + 1
    with pytest.raises(ValueError):
        port_bfs.device_ell(bad, CPU)


def _sparse_rows(rng, rows: int, W: int, occupied: float) -> np.ndarray:
    """[rows, W] uint32 words with ~`occupied` of the rows non-empty."""
    m = rng.integers(0, 2**32, (rows, W), dtype=np.uint32)
    m[rng.random(rows) >= occupied] = 0
    return m


@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fused_ell_hop_equals_reference_then_first_visit(name, W):
    """The fused hop (plain versions on the CPU) == the reference's
    _ell_hop followed by fresh = nxt & ~seen, seen | fresh; its flags are
    exactly fresh's non-empty rows."""
    rel = GRAPHS[name]()
    g = port_bfs.build_ell(rel.indptr, rel.indices)
    rng = np.random.default_rng(13 + W)
    fr = _sparse_rows(rng, g.n + 1, W, 0.5)
    fr[g.n] = 0
    seen = _sparse_rows(rng, g.n + 1, W, 0.7)
    seen &= rng.integers(0, 2**32, seen.shape, dtype=np.uint32)
    seen[g.n] = 0
    ref_prep = ref_bfs.prepare_parts(ref_bfs.device_ell(g), W)
    nxt = np.asarray(ref_bfs._ell_hop(ref_prep, jnp.asarray(fr), W))
    want_fresh = nxt & ~seen
    want_seen = seen | want_fresh

    prep = port_bfs.prepare_parts(port_bfs.device_ell(g, CPU))
    fr_t = torch.from_numpy(fr.view(np.int32).copy())
    seen_t = torch.from_numpy(seen.view(np.int32).copy())
    flags = port_bfs.row_flags(fr_t)
    assert np.array_equal(flags.numpy(), (fr != 0).any(1))
    out_flags = torch.full((g.n + 1,), 7, dtype=torch.uint8)
    fresh = port_bfs._ell_hop(prep, fr_t, flags=flags, seen=seen_t,
                              out_flags=out_flags)
    assert np.array_equal(_u32(fresh), want_fresh)
    assert np.array_equal(_u32(seen_t), want_seen)
    assert torch.equal(out_flags, fresh.ne(0).any(1).to(torch.uint8))
    assert np.array_equal(_u32(fr_t), fr), "the frontier is only read"
    # without the epilogue the same launches give the reference's nxt
    plain_flags = torch.empty(g.n + 1, dtype=torch.uint8)
    got = port_bfs._ell_hop(prep, fr_t, flags=flags, out_flags=plain_flags)
    assert np.array_equal(_u32(got), nxt)
    assert np.array_equal(plain_flags.numpy(), (nxt != 0).any(1))


@pytest.mark.parametrize("n_b,K,W", [(256, 1, 4), (256, 3, 1), (512, 16, 2),
                                     (256, 8, 3), (256, 1024, 1)])
def test_bucket_hop_plain_flags_contract(n_b, K, W):
    """Exact flags, all-ones flags and no flags give the same hop; a 0
    flag on a non-empty row makes that row count as empty (the contract:
    a 1 on an empty row is allowed, a 0 on a non-empty row is a bug)."""
    rng = np.random.default_rng(17)
    n = 1000
    nbr = rng.integers(0, n + 1, (n_b, K)).astype(np.int32)
    frontier = _sparse_rows(rng, n + 1, W, 0.2)
    r = int(nbr[0, 0]) % n
    nbr[0] = r                         # row 0 reads only frontier row r
    frontier[r] = 0xFFFFFFFF
    frontier[n] = 0
    want = _numpy_bucket_hop(nbr, frontier)
    pallas = np.asarray(bucket_hop_pallas(jnp.asarray(nbr),
                                          jnp.asarray(frontier)))
    assert np.array_equal(pallas, want)
    fr_t = torch.from_numpy(frontier.view(np.int32))
    nbr_t = torch.from_numpy(nbr)
    exact = port_bfs.row_flags(fr_t)
    for flags in (None, exact, torch.ones(n + 1, dtype=torch.uint8)):
        out_flags = torch.empty(n_b + 2, dtype=torch.uint8)
        out = torch.zeros((n_b + 2, W), dtype=torch.int32)
        bucket_hop(nbr_t, fr_t, out, row0=1, flags=flags,
                   out_flags=out_flags)
        assert np.array_equal(_u32(out)[1:1 + n_b], want)
        assert np.array_equal(out_flags[1:1 + n_b].numpy(),
                              (want != 0).any(1))
    wrong = exact.clone()
    wrong[r] = 0
    got = _u32(bucket_hop_plain(nbr_t, fr_t, flags=wrong))
    fr_r = frontier.copy()
    fr_r[r] = 0
    assert np.array_equal(got, _numpy_bucket_hop(nbr, fr_r))
    assert not got[0].any() and want[0].all()


@pytest.mark.parametrize("case", ["out_is_frontier", "out_overlaps_frontier",
                                  "seen_is_frontier", "seen_is_out",
                                  "out_flags_is_flags"])
def test_bucket_hop_rejects_aliased_buffers(case):
    """Other blocks gather from the frontier while a launch writes out,
    seen and out_flags: the wrapper refuses shared memory, on the CPU
    as on the card."""
    fr = torch.arange(36, dtype=torch.int32).reshape(9, 4)
    nbr = torch.tensor([[0, 1], [2, 8], [3, 3]], dtype=torch.int32)
    flags = port_bfs.row_flags(fr)
    out = torch.zeros((9, 4), dtype=torch.int32)
    seen = torch.zeros((9, 4), dtype=torch.int32)
    kw = {"out": out, "seen": seen, "flags": flags,
          "out_flags": torch.zeros(9, dtype=torch.uint8)}
    kw.update({"out_is_frontier": {"out": fr, "seen": None},
               "out_overlaps_frontier": {"out": fr[3:], "seen": None,
                                         "out_flags": None},
               "seen_is_frontier": {"seen": fr},
               "seen_is_out": {"seen": out},
               "out_flags_is_flags": {"out_flags": flags}}[case])
    with pytest.raises(ValueError, match="share memory"):
        bucket_hop(nbr, fr, kw.pop("out"), **kw)
    # separate buffers are fine
    bucket_hop(nbr, fr, out, seen=seen, flags=flags,
               out_flags=torch.zeros(9, dtype=torch.uint8))


def _random_masks(rng, rows: int, W: int, count: int, occupied: float):
    """`count` [rows + 1, W] uint32 masks, ~`occupied` of the rows
    non-empty, zero sentinel row last."""
    out = []
    for _ in range(count):
        m = _sparse_rows(rng, rows + 1, W, occupied)
        m[rows] = 0
        out.append(m)
    return out


@pytest.mark.parametrize("first_visit", [True, False])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_make_ell_step_equals_reference(name, W, first_visit):
    """Two resumed stages (3 hops, then 2 from the carries): frontier,
    seen and the per-hop masks bit-equal to the reference's step — the
    first-visit sets, or the full level DAG with seen untouched."""
    rel = GRAPHS[name]()
    g = port_bfs.build_ell(rel.indptr, rel.indices)
    rng = np.random.default_rng(19 + W)
    (m0,) = _random_masks(rng, g.n, W, 1, 0.02)
    ref_step = ref_bfs.make_ell_step(ref_bfs.device_ell(g), g.n, W,
                                     first_visit=first_visit)
    step = port_bfs.make_ell_step(port_bfs.device_ell(g, CPU), g.n, W,
                                  first_visit=first_visit)
    r_f, r_s = jax.device_put(m0), jax.device_put(m0)
    f, s = port_bfs.put_mask(m0, CPU), port_bfs.put_mask(m0, CPU)
    seen_in = s
    for depth in (3, 2):
        r_f, r_s, r_hops = ref_step(r_f, r_s, depth)
        f, s, hops = step(f, s, depth)
        assert hops.shape == (depth, g.n + 1, W)
        assert np.array_equal(_u32(hops), np.asarray(r_hops))
        assert np.array_equal(_u32(f), np.asarray(r_f))
        assert np.array_equal(_u32(s), np.asarray(r_s))
        assert s is seen_in, "seen is the carry, updated in place"
    if not first_visit:
        assert np.array_equal(_u32(s), m0)


def test_make_ell_step_refuses_aliased_carries():
    rel = GRAPHS["powerlaw"]()
    g = port_bfs.build_ell(rel.indptr, rel.indices)
    step = port_bfs.make_ell_step(port_bfs.device_ell(g, CPU), g.n, 1)
    m = port_bfs.put_mask(port_bfs.pack_seed_masks(
        g, _seeds(g.n, 32, seed=2)), CPU)
    with pytest.raises(ValueError, match="share memory"):
        step(m, m, 1)
    with pytest.raises(ValueError):
        step(m, torch.zeros((g.n, 1), dtype=torch.int32), 1)


def _tree_stages(graphs, W, port: bool):
    """The stage list of test_make_ell_tree in either package's form:
    graph 0 and graph 1 share n but not their permutations."""
    specs = [  # kind, graph, parent, filt, depth, keep_hops
        ("hop", 0, ("seed", 0), None, 0, False),
        ("hop", 1, ("stage", 0), 0, 0, False),        # filtered hop
        ("recurse", 0, ("seed", 1), None, 3, True),   # unfiltered recurse
        ("recurse", 1, ("seed", 2), 1, 2, True),      # filtered recurse
        ("hop", 0, ("stage", 2), None, 0, False),     # var-chained stage
        ("recurse", 0, ("stage", 1), 1, 2, False),    # filtered, seen only
    ]
    descs = []
    for kind, gi, parent, filt, depth, keep in specs:
        g = graphs[gi]
        perm_in = np.concatenate([g.perm_order, [g.n]])
        out_idx = np.concatenate([g.new_of_old, [g.n]])
        if port:
            prepared = port_bfs.prepare_parts(port_bfs.device_ell(g, CPU))
            perm_in = torch.from_numpy(perm_in.astype(np.int64))
            out_idx = torch.from_numpy(out_idx.astype(np.int64))
        else:
            prepared = ref_bfs.prepare_parts(ref_bfs.device_ell(g), W)
            perm_in = jnp.asarray(perm_in, jnp.int32)
            out_idx = jnp.asarray(out_idx, jnp.int32)
        descs.append({"kind": kind, "prepared": prepared,
                      "perm_in": perm_in, "out_idx": out_idx,
                      "parent": parent, "filt": filt, "depth": depth,
                      "keep_hops": keep})
    return descs


@pytest.mark.parametrize("W", [1, 2])
def test_make_ell_tree_equals_reference(W):
    """A hop, a filtered hop, an unfiltered recurse, a filtered recurse
    whose seeds fall outside its filter, a stage chained off a recurse
    stage's reachable set and a seen-only filtered recurse: every output
    bit-equal to the reference's make_ell_tree on two powerlaw graphs."""
    graphs = [port_bfs.build_ell(r.indptr, r.indices)
              for r in (powerlaw_rel(500, 8.0, seed=4),
                        powerlaw_rel(500, 4.0, seed=6))]
    n = graphs[0].n
    rng = np.random.default_rng(23 + W)
    seeds = _random_masks(rng, n, W, 3, 0.03)
    filts = _random_masks(rng, n, W, 2, 0.6)
    outside = seeds[2] & ~filts[1]
    assert outside[:n].any(), "some seeds must lie outside the filter"
    want = ref_bfs.make_ell_tree(_tree_stages(graphs, W, False), n, W)(
        tuple(jnp.asarray(m) for m in seeds),
        tuple(jnp.asarray(m) for m in filts))
    fn = port_bfs.make_ell_tree(_tree_stages(graphs, W, True), n, W)
    seeds_t = tuple(port_bfs.put_mask(m, CPU) for m in seeds)
    filts_t = tuple(port_bfs.put_mask(m, CPU) for m in filts)
    got = fn(seeds_t, filts_t)
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, tuple):
            assert np.array_equal(_u32(a[0]), np.asarray(b[0])), i
            assert np.array_equal(_u32(a[1]), np.asarray(b[1])), i
        else:
            assert np.array_equal(_u32(a), np.asarray(b)), i
    # the seeds the filter excludes stay in the filtered recurse's set
    assert np.array_equal(_u32(got[3][0]) & outside, outside)
    for m, t in zip(seeds + filts, seeds_t + filts_t):
        assert np.array_equal(_u32(t), m), "seeds and filters are only read"


# -- the launch table (ops/bucket_hop.py build_table, ops/bfs.py hop_table) --

def _heavy():
    """A has_tag-like graph: a powerlaw graph plus a hub whose in-neighbours
    are every node (2,500 tiles: a K2 = 4096 combine row) and one of
    5,000 (K2 = 1024)."""
    n = 20_000
    base = powerlaw_rel(n, 4.0, seed=8)
    src = np.repeat(np.arange(n, dtype=np.int32), np.diff(base.indptr))
    rng = np.random.default_rng(8)
    hub2 = rng.choice(n, 5_000, replace=False).astype(np.int32)
    src = np.concatenate([src, np.arange(n, dtype=np.int32), hub2])
    dst = np.concatenate([base.indices, np.full(n, 7, np.int32),
                          np.full(5_000, 11, np.int32)])
    return _csr_from_pairs(src, dst.astype(np.int32), n)


_HEAVY = {}


def _heavy_ell():
    if "g" not in _HEAVY:
        rel = _heavy()
        _HEAVY["g"] = port_bfs.build_ell(rel.indptr, rel.indices)
    return _HEAVY["g"]


def _rule(n_b, K, wv):
    """The body rule as the kernel's source note states it."""
    if wv >= 32:
        if K >= 64 and n_b <= 1024:
            return "split", -(-K // 4096)
        return "warp", 1
    lanes = 1 << (wv - 1).bit_length()            # lanes of a row
    groups = 32 // lanes                          # slot groups of a warp
    if K >= 16 * groups and n_b <= 1024:
        return "narrow_block", -(-K // (16 * 8 * groups))
    # rounds of four slot reads, the threads spread over 132 x 1024
    wave = 132 * 1024
    warp = -(-K // (4 * groups)) * max(1.0, 32 * n_b / wave)
    thread = -(-K // 4) * max(1.0, lanes * n_b / wave)
    return ("narrow_warp", 1) if warp < thread else ("narrow", 1)


def _table(g, W):
    from dgraph_tpu_torch.ops.bucket_hop import HopTable
    prep = port_bfs.prepare_parts(port_bfs.device_ell(g, CPU))
    fr = torch.zeros((g.n + 1, W), dtype=torch.int32)
    tab = port_bfs.hop_table(prep, fr, torch.zeros_like(fr))
    assert isinstance(tab, HopTable) and tab.W == W
    assert port_bfs.hop_table(prep, fr, torch.zeros_like(fr)) is tab, \
        "one table per (prepared graph, width)"
    return prep, tab


@pytest.mark.parametrize("W", [1, 3, 4, 32, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS) + ["heavy"])
def test_launch_table_covers_every_row_once(name, W):
    """Every row of [0, n] of the result, the sentinel included, and every
    row of the partials [0, M], the zero row M included, is written by
    exactly one entry; level 1 reads the frontier and writes the
    partials, level 2 only reads them; the entries' blocks tile the
    grid of their launch."""
    from dgraph_tpu_torch.ops.bucket_hop import F, OUT, PARTIALS, ZERO
    g = (_heavy_ell() if name == "heavy" else
         port_bfs.build_ell(GRAPHS[name]().indptr, GRAPHS[name]().indices))
    prep, tab = _table(g, W)
    M = g.tiles.shape[0] if g.tiles is not None and g.seg_rows else None
    out_cover = np.zeros(g.n + 1, np.int64)
    part_cover = np.zeros(M + 1 if M is not None else 0, np.int64)
    assert 1 <= len(tab.levels) <= 2
    assert (len(tab.levels) == 2) == (M is not None)
    for li, level in enumerate(tab.levels):
        rows = level.rows
        assert rows.shape == (len(level.idx), 12)
        assert list(rows[:, F["block0"]]) == list(
            np.concatenate([[0], np.cumsum(rows[:, F["blocks"]])[:-1]]))
        assert (rows[:, F["blocks"]] > 0).all()
        assert level.blocks == int(rows[:, F["blocks"]].sum())
        for r, e in zip(rows, level.idx):
            row0, n_b = int(r[F["row0"]]), int(r[F["n_b"]])
            assert n_b > 0
            assert (e is None) == (r[F["body"]] == ZERO)
            if r[F["dst"]] == OUT:
                out_cover[row0:row0 + n_b] += 1
            else:
                assert r[F["dst"]] == PARTIALS and li == 0
                part_cover[row0:row0 + n_b] += 1
            if e is not None:
                assert r[F["idx"]] == e.data_ptr()
                assert tuple(e.shape) == (n_b, int(r[F["K"]]))
    assert (out_cover == 1).all()
    assert (part_cover == 1).all()
    assert tab.out_rows == g.n + 1 and tab.src_rows == g.n + 1
    assert tab.part_rows == (M + 1 if M is not None else 0)


@pytest.mark.parametrize("W", [1, 3, 4, 32, 128])
def test_launch_table_bodies_follow_the_rule(W):
    """Each entry's body and parts are the source note's rule of
    (n_b, K, wv), wv the row's int4 words when W % 4 == 0 (int32 words
    else); zero rows take the zero body; a split row owns a ticket and
    `parts` scratch rows of its own."""
    from dgraph_tpu_torch.ops.bucket_hop import BODIES, F, choose_body
    wv = W // 4 if W % 4 == 0 else W
    seen = set()
    tickets, scratch = [], []
    for name in sorted(GRAPHS) + ["heavy"]:
        g = (_heavy_ell() if name == "heavy" else
             port_bfs.build_ell(GRAPHS[name]().indptr,
                                GRAPHS[name]().indices))
        _prep, tab = _table(g, W)
        assert tab.vec4 == (W % 4 == 0)
        for level in tab.levels:
            for r in level.rows:
                body = BODIES[int(r[F["body"]])]
                if body == "zero":
                    continue
                n_b, K = int(r[F["n_b"]]), int(r[F["K"]])
                assert (body, int(r[F["parts"]])) == _rule(n_b, K, wv), \
                    (name, n_b, K)
                assert choose_body(n_b, K, wv)[0] == r[F["body"]]
                if body.startswith("narrow"):
                    assert 1 << int(r[F["lg"]]) >= wv > \
                        (1 << int(r[F["lg"]])) // 2
                seen.add(body)
                if r[F["parts"]] > 1:
                    tickets.append((name, int(r[F["ticket0"]]), n_b))
                    scratch.append((name, int(r[F["scratch0"]]),
                                    n_b * int(r[F["parts"]])))
    # per table, tickets and scratch rows are handed out without overlap
    for kind in (tickets, scratch):
        for name in {t[0] for t in kind}:
            spans = sorted((a, a + c) for nm, a, c in kind if nm == name)
            assert spans[0][0] == 0
            assert all(b0 == a1 for (_a0, a1), (b0, _b1)
                       in zip(spans, spans[1:]))
    want = ({"narrow", "narrow_warp", "narrow_block"} if wv < 32
            else {"warp", "split"})
    assert seen <= want and seen & {"narrow_block", "split"}
    # a heavy row past PART_SLOTS splits over blocks
    assert _rule(1, 131072, 1) == ("narrow_block", 32)
    assert choose_body(1, 131072, 1)[2] == 32
    assert choose_body(1, 131072, 8)[2] == 256
    # many rows of few slots stay a thread per row; few rows go a warp each
    assert _rule(65536, 8, 8) == ("narrow", 1)
    assert _rule(4096, 8, 1) == ("narrow_warp", 1)
    for n_b, K, wv in ((65536, 8, 8), (4096, 8, 1), (65536, 256, 1),
                       (65536, 64, 8), (300_000, 1024, 1), (20, 7, 3)):
        assert BODIES[choose_body(n_b, K, wv)[0]] == _rule(n_b, K, wv)[0]


def _heavy_fr(rng, n, W, occupied):
    fr = _sparse_rows(rng, n + 1, W, occupied)
    fr &= rng.integers(0, 2**32, fr.shape, dtype=np.uint32)
    fr[n] = 0
    return fr


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_flags", [False, True])
@pytest.mark.parametrize("W", [1, 4, 32])
@pytest.mark.parametrize("name", sorted(GRAPHS) + ["heavy"])
def test_ell_hop_table_walk_equals_reference(name, W, with_flags, fused):
    """The launch table walked by the plain version (the default hop on
    the CPU, and hop=bucket_hop_plain) == the reference's _ell_hop, with
    and without frontier flags, plain and with the first-visit
    epilogue; its flags are exactly the result's non-empty rows."""
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain
    g = (_heavy_ell() if name == "heavy" else
         port_bfs.build_ell(GRAPHS[name]().indptr, GRAPHS[name]().indices))
    rng = np.random.default_rng(29 + W)
    fr = _heavy_fr(rng, g.n, W, 0.3)
    seen = _heavy_fr(rng, g.n, W, 0.6)
    ref_prep = ref_bfs.prepare_parts(ref_bfs.device_ell(g), W)
    nxt = np.asarray(ref_bfs._ell_hop(ref_prep, jnp.asarray(fr), W))
    want = nxt & ~seen if fused else nxt
    prep = port_bfs.prepare_parts(port_bfs.device_ell(g, CPU))
    fr_t = torch.from_numpy(fr.view(np.int32).copy())
    flags = port_bfs.row_flags(fr_t) if with_flags else None
    for hop in (bucket_hop, bucket_hop_plain):
        seen_t = torch.from_numpy(seen.view(np.int32).copy())
        out_flags = torch.full((g.n + 1,), 7, dtype=torch.uint8)
        got = port_bfs._ell_hop(prep, fr_t, hop, flags=flags,
                                seen=seen_t if fused else None,
                                out_flags=out_flags)
        assert np.array_equal(_u32(got), want)
        assert np.array_equal(out_flags.numpy(), (want != 0).any(1))
        assert np.array_equal(_u32(seen_t), seen | want if fused else seen)
    assert np.array_equal(_u32(fr_t), fr), "the frontier is only read"


@pytest.mark.parametrize("W", [1, 4, 32])
def test_make_ell_recurse_heavy_equals_reference(W):
    """Depth 1-3 over the has_tag-like graph from random seed masks: last,
    seen, the per-hop masks and the exact per-lane edges == the
    reference's, bit for bit."""
    g = _heavy_ell()
    rng = np.random.default_rng(31 + W)
    mask0 = _heavy_fr(rng, g.n, W, 0.001)
    ref_fn = ref_bfs.make_ell_recurse(ref_bfs.device_ell(g), g.outdeg,
                                      g.n, W)
    fn = port_bfs.make_ell_recurse(port_bfs.device_ell(g, CPU), g.outdeg,
                                   g.n, W)
    for depth in (1, 3):
        r_last, r_seen, r_edges, r_hops = ref_fn(jax.device_put(mask0),
                                                 depth, True)
        last, seen, edges, hops = fn(port_bfs.put_mask(mask0, CPU), depth,
                                     True)
        assert np.array_equal(_u32(last), np.asarray(r_last))
        assert np.array_equal(_u32(seen), np.asarray(r_seen))
        assert np.array_equal(_u32(hops), np.asarray(r_hops))
        assert np.array_equal(edges.numpy(), np.asarray(r_edges))


@pytest.mark.parametrize("first_visit", [True, False])
@pytest.mark.parametrize("W", [1, 4, 32])
def test_make_ell_step_heavy_equals_reference(W, first_visit):
    """Two resumed stages (2 hops, then 1) over the has_tag-like graph:
    frontier, seen and the per-hop masks == the reference's step."""
    g = _heavy_ell()
    rng = np.random.default_rng(37 + W)
    m0 = _heavy_fr(rng, g.n, W, 0.002)
    ref_step = ref_bfs.make_ell_step(ref_bfs.device_ell(g), g.n, W,
                                     first_visit=first_visit)
    step = port_bfs.make_ell_step(port_bfs.device_ell(g, CPU), g.n, W,
                                  first_visit=first_visit)
    r_f, r_s = jax.device_put(m0), jax.device_put(m0)
    f, s = port_bfs.put_mask(m0, CPU), port_bfs.put_mask(m0, CPU)
    for depth in (2, 1):
        r_f, r_s, r_hops = ref_step(r_f, r_s, depth)
        f, s, hops = step(f, s, depth)
        assert np.array_equal(_u32(hops), np.asarray(r_hops))
        assert np.array_equal(_u32(f), np.asarray(r_f))
        assert np.array_equal(_u32(s), np.asarray(r_s))


@pytest.mark.parametrize("W", [1, 4, 32])
def test_make_ell_tree_heavy_equals_reference(W):
    """The six-stage tree of test_make_ell_tree_equals_reference over the
    has_tag-like graph and a powerlaw graph of the same n: every output
    == the reference's."""
    heavy = _heavy_ell()
    other = powerlaw_rel(heavy.n, 4.0, seed=12)
    graphs = [heavy, port_bfs.build_ell(other.indptr, other.indices)]
    n = heavy.n
    rng = np.random.default_rng(41 + W)
    seeds = _random_masks(rng, n, W, 3, 0.002)
    filts = _random_masks(rng, n, W, 2, 0.6)
    want = ref_bfs.make_ell_tree(_tree_stages(graphs, W, False), n, W)(
        tuple(jnp.asarray(m) for m in seeds),
        tuple(jnp.asarray(m) for m in filts))
    got = port_bfs.make_ell_tree(_tree_stages(graphs, W, True), n, W)(
        tuple(port_bfs.put_mask(m, CPU) for m in seeds),
        tuple(port_bfs.put_mask(m, CPU) for m in filts))
    assert len(got) == len(want) == 6
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, tuple):
            assert np.array_equal(_u32(a[0]), np.asarray(b[0])), i
            assert np.array_equal(_u32(a[1]), np.asarray(b[1])), i
        else:
            assert np.array_equal(_u32(a), np.asarray(b)), i


def test_launch_table_refuses_what_the_kernel_cannot_take():
    """Rows outside the destination, a non-int32 index block, a mask of
    the wrong width or rows, and a pointer-only (one-bucket) table
    walked: each raises ValueError before any launch."""
    from dgraph_tpu_torch.ops import bucket_hop as bh
    nbr = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        bh.build_table([[(nbr, 3, 2, bh.OUT)]], 1, False, CPU, out_rows=4)
    with pytest.raises(ValueError, match="int32"):
        bh.build_table([[(nbr.long(), 3, 0, bh.OUT)]], 1, False, CPU,
                       out_rows=4)
    tab = bh.build_table([[(nbr, 3, 0, bh.OUT)]], 2, False, CPU,
                         out_rows=4, src_rows=5)
    fr = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        bh.run_table(tab, fr, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        bh.run_table(tab, fr[:4], torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="width"):
        bh.run_table(tab, fr, torch.zeros((4, 3), dtype=torch.int32))
    got = bh.run_table(tab, fr, torch.full((4, 2), -1, dtype=torch.int32))
    assert (got[:3] == 0).all() and (got[3] == -1).all()
    tab.levels[0].idx = None
    with pytest.raises(ValueError, match="pointers only"):
        bh.walk_table(tab, fr, torch.zeros((4, 2), dtype=torch.int32))
