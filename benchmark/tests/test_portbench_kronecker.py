import torch

from benchmark.reference import kronecker


def edges(seed, scale=8, ef=16):
    return kronecker.kronecker_edges(scale, ef, 0.57, 0.19, 0.19, seed)


def test_same_seed_same_graph_other_seed_another():
    a, b, c = edges(3), edges(3), edges(4)
    assert torch.equal(a, b)
    assert a.shape != c.shape or not torch.equal(a, c)


def test_shapes_and_range():
    e = edges(2 ** 31 + 11, scale=9, ef=8)
    assert e.dtype == torch.int64 and e.shape[0] == 2
    assert 0 < e.shape[1] <= 8 * 2 ** 9
    assert int(e.min()) >= 0 and int(e.max()) < 2 ** 9
    assert not bool((e[0] == e[1]).any())          # self-loops dropped


def test_quadrant_skew_follows_a_b_c_d():
    # before the label permutation the first bit level picks the row half
    # with A + B = 0.76; the permutation keeps the degree skew: the top
    # 1 % of vertices hold far more than 1 % of the edge ends
    e = edges(5, scale=12, ef=16)
    deg = torch.bincount(e.reshape(-1), minlength=2 ** 12).sort(
        descending=True).values
    top = int(deg[: 2 ** 12 // 100].sum())
    assert top > 0.1 * int(deg.sum())


def test_undirected_csr_and_roots_of_degree_one_or_more():
    e = torch.tensor([[0, 1, 1, 3, 0], [1, 0, 2, 3 + 1, 1]])
    indptr, indices = kronecker.undirected_csr(e, 6)
    rows = [indices[indptr[v]:indptr[v + 1]].tolist() for v in range(6)]
    assert rows == [[1], [0, 2], [1], [4], [3], []]
    assert kronecker.root_candidates(e, 6).tolist() == [0, 1, 2, 3, 4]
