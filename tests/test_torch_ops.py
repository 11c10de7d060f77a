"""Port ops/{uidalgebra,hop,level} == the JAX package, outputs whole.

Each case builds its inputs with numpy from a seed, runs the JAX
function (jitted, on the JAX CPU backend) and its torch counterpart on
CPU tensors, and compares every output array element for element:
padding slots, counts and overflow signals included. Exact everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgraph_tpu.models.synthetic import powerlaw_rel
from dgraph_tpu.ops import hop as ref_hop
from dgraph_tpu.ops import level as ref_level
from dgraph_tpu.ops import uidalgebra as ref_ua
from dgraph_tpu_torch.ops import hop as port_hop
from dgraph_tpu_torch.ops import level as port_level
from dgraph_tpu_torch.ops import uidalgebra as port_ua

CPU = "cpu"
torch.set_num_threads(1)
SNT = int(np.iinfo(np.int32).max)


def same(ref_out, port_out):
    """Compare a JAX output tree with the port's, whole."""
    if isinstance(ref_out, tuple):
        assert isinstance(port_out, tuple) and len(ref_out) == len(port_out)
        for r, p in zip(ref_out, port_out):
            same(r, p)
        return
    r = np.asarray(ref_out)
    p = port_out.cpu().numpy()
    assert r.shape == p.shape, (r.shape, p.shape)
    assert np.array_equal(r, p), (r, p)


def sorted_set(rng, n, hi=1000):
    return np.sort(rng.choice(hi, n, replace=False)).astype(np.int32)


def both(a, cap):
    """The same padded set for both packages."""
    return (ref_ua.pad_to(a, cap), port_ua.pad_to(a, cap, CPU))


# -- uidalgebra --------------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(0, 1), (0, 8), (5, 8), (64, 64)])
def test_pad_count_valid(n, cap):
    a = sorted_set(np.random.default_rng(n + cap), n)
    r, p = both(a, cap)
    same(r, p)
    same(ref_ua.count_valid(r), port_ua.count_valid(p))
    same(ref_ua.valid_mask(r), port_ua.valid_mask(p))


def test_pad_overflow_raises():
    with pytest.raises(ValueError, match="exceeds capacity"):
        port_ua.pad_to(np.arange(5), 4, CPU)


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 7), (7, 0), (20, 30),
                                   (100, 10), (64, 64)])
@pytest.mark.parametrize("op", ["intersect_sorted", "difference_sorted",
                                "merge_sorted"])
def test_set_ops(op, na, nb):
    rng = np.random.default_rng(na * 131 + nb)
    a, b = sorted_set(rng, na, 200), sorted_set(rng, nb, 200)
    ra, pa = both(a, max(na, 1) + 3)
    rb, pb = both(b, max(nb, 1) + 5)
    same(getattr(ref_ua, op)(ra, rb), getattr(port_ua, op)(pa, pb))
    # an explicit, smaller output size truncates the same way
    size = max(na // 2, 1)
    same(getattr(ref_ua, op)(ra, rb, size=size),
         getattr(port_ua, op)(pa, pb, size=size))


@pytest.mark.parametrize("size", [1, 7, 40, 300])
@pytest.mark.parametrize("n_pad", [0, 9])
def test_sort_unique_count(size, n_pad):
    """Unsorted input with duplicates and sentinel padding mixed in;
    sizes below the unique count signal truncation (n_unique > size)."""
    rng = np.random.default_rng(size + n_pad)
    x = np.concatenate([rng.integers(0, 60, 200),
                        np.full(n_pad, SNT)]).astype(np.int32)
    rng.shuffle(x)
    r = ref_ua.sort_unique_count(jnp.asarray(x), size)
    p = port_ua.sort_unique_count(torch.from_numpy(x), size)
    same(r, p)
    if size < 60:
        assert int(p[1]) > size


@pytest.mark.parametrize("n_keep", [0, 3, 50])
@pytest.mark.parametrize("size", [1, 10, 64])
def test_compact_with_count(n_keep, size):
    rng = np.random.default_rng(n_keep * 7 + size)
    vals = rng.integers(0, 1000, 64).astype(np.int32)
    keep = np.zeros(64, bool)
    keep[rng.choice(64, n_keep, replace=False)] = True
    same(ref_ua.compact_with_count(jnp.asarray(vals), jnp.asarray(keep),
                                   size),
         port_ua.compact_with_count(torch.from_numpy(vals),
                                    torch.from_numpy(keep), size))


def test_index_of_contains():
    rng = np.random.default_rng(4)
    a = sorted_set(rng, 30, 100)
    ra, pa = both(a, 40)
    for v in list(a[:5]) + [0, 99, 101, SNT - 1, int(a[-1])]:
        same(ref_ua.index_of(ra, v), port_ua.index_of(pa, v))
        same(ref_ua.contains(ra, v), port_ua.contains(pa, v))


@pytest.mark.parametrize("offset,first", [
    (0, 0), (0, 3), (2, 3), (0, -2), (1, -3), (8, 0), (12, 5), (0, -50),
    (3, port_level.NO_LIMIT)])
def test_take_page(offset, first):
    a = np.arange(1, 11, dtype=np.int32) * 3
    ra, pa = both(a, 16)
    same(ref_ua.take_page(ra, offset, first, 16),
         port_ua.take_page(pa, offset, first, 16))


# -- hop ---------------------------------------------------------------------

def graph(n=200, deg=4.0, seed=3, zero_rows=0.2):
    """A powerlaw CSR with a share of its rows emptied (zero-degree
    nodes in the frontier)."""
    rel = powerlaw_rel(n, deg, seed)
    rng = np.random.default_rng(seed)
    d = np.diff(rel.indptr)
    d[rng.random(n) < zero_rows] = 0
    indices = np.concatenate([rel.row(i)[:d[i]] for i in range(n)]
                             ).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(d)]).astype(np.int32)
    return indptr, indices


def csr_both(indptr, indices):
    return ((jnp.asarray(indptr), jnp.asarray(indices)),
            (torch.from_numpy(indptr), torch.from_numpy(indices)))


@pytest.mark.parametrize("n_front,cap", [(0, 1), (0, 16), (10, 16),
                                         (60, 64), (200, 256)])
def test_frontier_degrees(n_front, cap):
    indptr, indices = graph()
    (ri, _), (pi, _) = csr_both(indptr, indices)
    fr = sorted_set(np.random.default_rng(n_front), n_front, 200)
    rf, pf = both(fr, cap)
    same(ref_hop.frontier_degrees(ri, rf), port_hop.frontier_degrees(pi, pf))


@pytest.mark.parametrize("zero_rows", [0.0, 0.2, 0.9])
@pytest.mark.parametrize("n_front,f_cap,edge_cap", [
    (0, 16, 64),          # empty frontier: every slot masked
    (1, 1, 64),
    (12, 16, 64),
    (40, 64, 512),
    (40, 64, 32),         # total > edge_cap: the overflow is signalled
    (200, 256, 2048)])
def test_gather_edges(n_front, f_cap, edge_cap, zero_rows):
    indptr, indices = graph(zero_rows=zero_rows)
    (ri, rx), (pi, px) = csr_both(indptr, indices)
    fr = sorted_set(np.random.default_rng(n_front + 1), n_front, 200)
    rf, pf = both(fr, f_cap)
    r = ref_hop.gather_edges(ri, rx, rf, edge_cap)
    p = port_hop.gather_edges(pi, px, pf, edge_cap)
    same(r, p)
    want = int(np.diff(indptr)[fr].sum()) if n_front else 0
    assert int(p[4]) == want
    if want > edge_cap:
        assert int(p[4]) > edge_cap


@pytest.mark.parametrize("n_front,edge_cap,out_cap", [
    (0, 64, 16), (30, 256, 256), (30, 256, 8),    # n_unique > out_cap
    (30, 16, 64), (120, 1024, 1024)])
def test_expand_frontier(n_front, edge_cap, out_cap):
    indptr, indices = graph(seed=8)
    (ri, rx), (pi, px) = csr_both(indptr, indices)
    fr = sorted_set(np.random.default_rng(n_front + 2), n_front, 200)
    rf, pf = both(fr, 128)
    same(ref_hop.expand_frontier(ri, rx, rf, edge_cap, out_cap),
         port_hop.expand_frontier(pi, px, pf, edge_cap, out_cap))


def test_launch_key():
    indptr, indices = graph()
    (ri, _), (pi, _) = csr_both(indptr, indices)
    rf, pf = both(np.arange(5, dtype=np.int32), 8)
    assert (ref_hop.launch_key(ri, rf, 64, 8)
            == port_hop.launch_key(pi, pf, 64, 8))


# -- level -------------------------------------------------------------------

FIRSTS = [ref_level.NO_LIMIT, 1, 3, -1, -2, 0]


@pytest.mark.parametrize("use_allowed", [False, True])
@pytest.mark.parametrize("first", FIRSTS)
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_expand_level(use_allowed, first, offset):
    indptr, indices = graph(seed=5)
    (ri, rx), (pi, px) = csr_both(indptr, indices)
    rng = np.random.default_rng(offset * 17 + first % 97)
    fr = sorted_set(rng, 50, 200)
    rf, pf = both(fr, 64)
    allowed = sorted_set(rng, 90, 200) if use_allowed else np.zeros(0)
    ra, pa = both(allowed, 128 if use_allowed else 1)
    edge_cap = 512
    r = ref_level.expand_level(ri, rx, rf, ra, np.int32(offset),
                               np.int32(first), edge_cap=edge_cap,
                               out_cap=edge_cap, use_allowed=use_allowed)
    p = port_level.expand_level(pi, px, pf, pa, offset, first,
                                edge_cap=edge_cap, out_cap=edge_cap,
                                use_allowed=use_allowed)
    same(r, p)


@pytest.mark.parametrize("case", ["empty", "overflow", "small_out"])
def test_expand_level_edges(case):
    """Empty frontier, total > edge_cap and n_unique > out_cap."""
    indptr, indices = graph(seed=6)
    (ri, rx), (pi, px) = csr_both(indptr, indices)
    fr = (np.zeros(0, np.int32) if case == "empty"
          else sorted_set(np.random.default_rng(9), 60, 200))
    rf, pf = both(fr, 64)
    ra, pa = both(np.zeros(0), 1)
    edge_cap, out_cap = {"empty": (64, 64), "overflow": (32, 32),
                         "small_out": (1024, 4)}[case]
    r = ref_level.expand_level(ri, rx, rf, ra, np.int32(1), np.int32(2),
                               edge_cap=edge_cap, out_cap=out_cap,
                               use_allowed=False)
    p = port_level.expand_level(pi, px, pf, pa, 1, 2, edge_cap=edge_cap,
                                out_cap=out_cap, use_allowed=False)
    same(r, p)


@pytest.mark.parametrize("first", FIRSTS)
def test_filter_paginate(first):
    """The shared body on hand-made edge slots: every row shape (empty,
    one edge, all filtered) with the same (seg, valid) layout."""
    rng = np.random.default_rng(first % 101)
    seg = np.sort(rng.integers(0, 12, 96)).astype(np.int32)
    nbrs = rng.integers(0, 80, 96).astype(np.int32)
    valid = np.arange(96) < 90
    nbrs[~valid] = SNT
    pos = np.arange(96, dtype=np.int32) + 7
    allowed = sorted_set(rng, 30, 80)
    ra, pa = both(allowed, 32)
    r = ref_level.filter_paginate(
        jnp.asarray(nbrs), jnp.asarray(seg), jnp.asarray(pos),
        jnp.asarray(valid), ra, jnp.int32(1), jnp.int32(first), 12, True)
    p = port_level.filter_paginate(
        torch.from_numpy(nbrs), torch.from_numpy(seg), torch.from_numpy(pos),
        torch.from_numpy(valid), pa, 1, first, 12, True)
    same(r, p)


# -- recurse -----------------------------------------------------------------

@pytest.mark.parametrize("use_allowed", [False, True])
@pytest.mark.parametrize("n_front,n_seen,edge_cap,out_cap", [
    (0, 0, 64, 64),          # empty frontier
    (20, 0, 512, 512),
    (20, 120, 512, 512),     # most neighbours already visited
    (50, 30, 64, 512),       # total > edge_cap: the overflow is signalled
    (50, 30, 512, 16)])      # n_unique > out_cap
def test_masked_hop(use_allowed, n_front, n_seen, edge_cap, out_cap):
    from dgraph_tpu.ops import recurse as ref_rec
    from dgraph_tpu_torch.ops import recurse as port_rec

    indptr, indices = graph(seed=12)
    (ri, rx), (pi, px) = csr_both(indptr, indices)
    n = len(indptr) - 1
    rng = np.random.default_rng(n_front * 7 + n_seen + edge_cap + out_cap)
    fr = sorted_set(rng, n_front, n)
    rf, pf = both(fr, 64)
    allowed = sorted_set(rng, 120, n) if use_allowed else np.zeros(0)
    ra, pa = both(allowed, 128 if use_allowed else 1)
    seen = np.zeros(n, np.int8)
    seen[rng.choice(n, n_seen, replace=False)] = 1
    seen[fr] = 1
    r = ref_rec.masked_hop(ri, rx, rf, ra, jnp.asarray(seen), edge_cap,
                           out_cap, use_allowed)
    p_seen = torch.from_numpy(np.concatenate([seen, [0]]).astype(np.int8))
    p = port_rec.masked_hop(pi, px, pf, pa, p_seen, edge_cap, out_cap,
                            use_allowed)
    # the port's bitmap has one spare slot past the ranks
    same(r[:5] + r[6:], p[:5] + p[6:])
    same(r[5], p[5][:n])

