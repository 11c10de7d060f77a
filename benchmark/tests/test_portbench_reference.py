import json
from collections import deque

import numpy as np
import pytest
import torch

from benchmark.reference import kronecker, rag, snb, traverse


def brute_count(adj_lists, root, depth):
    dist = {root: 0}
    q = deque([root])
    while q:
        u = q.popleft()
        if dist[u] + 1 > depth - 1:
            continue
        for v in adj_lists[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                q.append(v)
    return sum(len(adj_lists[u]) for u in dist)


@pytest.mark.parametrize("seed", [1, 7, 2 ** 31 + 5])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_lane_counts_match_a_breadth_first_walk(seed, depth):
    n = 2 ** 8
    e = kronecker.kronecker_edges(8, 4, 0.57, 0.19, 0.19, seed)
    indptr, indices = kronecker.undirected_csr(e, n)
    lists = [indices[indptr[v]:indptr[v + 1]].tolist() for v in range(n)]
    deg = indptr[1:] - indptr[:-1]
    roots = kronecker.root_candidates(e, n)[:40]
    got = traverse.lane_counts(traverse.adjacency(indptr, indices, n), deg,
                               roots, depth, block=16)
    assert got.tolist() == [brute_count(lists, int(r), depth) for r in roots]


def test_hop_occupancy_matches_per_lane_levels():
    n = 2 ** 7
    e = kronecker.kronecker_edges(7, 4, 0.57, 0.19, 0.19, 9)
    indptr, indices = kronecker.undirected_csr(e, n)
    deg = indptr[1:] - indptr[:-1]
    roots = kronecker.root_candidates(e, n)[:10]
    adj = traverse.adjacency(indptr, indices, n)
    hops = traverse.hop_occupancy(adj, deg, roots, 3, block=4)
    lists = [indices[indptr[v]:indptr[v + 1]].tolist() for v in range(n)]
    front = [set() for _ in range(3)]
    fresh = [set() for _ in range(3)]
    for r in roots.tolist():
        level = {r}
        seen = {r}
        for h in range(3):
            front[h] |= level
            nxt = {v for u in level for v in lists[u]} - seen
            fresh[h] |= nxt
            seen |= nxt
            level = nxt
    for h in range(3):
        assert hops[h]["occupied_rows"] == len(front[h])
        assert hops[h]["fresh_rows"] == len(fresh[h])
        assert hops[h]["occupied_slots"] == sum(len(lists[u])
                                                for u in front[h])
        assert hops[h]["nxt_rows"] == len({v for u in front[h]
                                           for v in lists[u]})


def test_float32_counts_lose_exactness_above_2_to_24():
    # an odd total above 2^24 has no float32 value
    deg = torch.full((4095,), 2 ** 13 + 1, dtype=torch.int64)
    front = torch.ones((4095, 3), dtype=torch.float32)
    exact = traverse._count(deg, front, "float64")
    low = traverse._count(deg, front, "float32")
    assert exact.tolist() == [4095 * (2 ** 13 + 1)] * 3
    assert (low.to(torch.float64) != exact).all()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -2.5 - 2 ** -12])
    got = rag.tf32(x).tolist()
    assert got == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10, -2.5]


def test_scanner_gap_is_zero_for_the_exact_set_and_positive_otherwise():
    g = torch.Generator().manual_seed(3)
    vecs = torch.randn((500, 16), generator=g)
    q = torch.randn((2, 16), generator=g)
    sc = rag.Scanner(vecs, block=1)
    s = (vecs.double() @ q.double().T)
    best = [sorted((torch.topk(s[:, j], 5).indices + 1).tolist())
            for j in range(2)]
    worse = [best[0][:-1] + [int(torch.topk(s[:, 0], 9).indices[-1]) + 1],
             best[1][:3]]
    assert sc.gaps(q, best, [5, 5]) == [0.0, 0.0]
    gaps = sc.gaps(q, worse, [5, 5])
    assert gaps[0] > 0 and gaps[1] is None


def tiny_graph():
    g = snb.generate(sf=0.005, seed=4)
    return g, rag.Graph(g, snb.TAG_NAMES)


def test_recurse_is_visit_once_and_binds_means_of_kept_children():
    g, graph = tiny_graph()
    # a post with replies, and a reply of it as a second root: the edge
    # to the second root is not kept
    indptr, indices = graph.replies
    post = next(u for u in g.post_uids.tolist()
                if indptr[u + 1] - indptr[u] >= 2)
    kids = indices[indptr[post]:indptr[post + 1]].tolist()
    vecs = np.arange((g.n_nodes + 1) * 2, dtype=np.float32).reshape(-1, 2)
    out = rag.render(graph, "knn_featprop", sorted([post, kids[0]]), vecs)
    objs = {int(o["uid"], 16): o for o in out["q"]}
    kept = [int(c["uid"], 16) for c in objs[post]["~reply_of"]]
    assert kids[0] not in kept and sorted(kept) == kept
    want = vecs[np.asarray(kept) - 1].astype(np.float64).mean(0)
    assert np.allclose(objs[post]["mean(emb)"], want)


def test_compare_reads_structure_and_mean_error():
    want = {"q": [{"uid": "0x1", "mean(emb)": [1.0, 2.0],
                   "~reply_of": [{"uid": "0x2"}]}]}
    got = json.loads(json.dumps(want))
    got["q"][0]["mean(emb)"][1] = 2.0 + 1e-6
    ok, err = rag.compare(got, want)
    assert ok and 0 < err < 2e-6
    got["q"][0]["~reply_of"][0]["uid"] = "0x3"
    assert not rag.compare(got, want)[0]
    assert not rag.compare({"q": []}, want)[0]
