"""The Graph500 Kronecker generator (Graph500 specification, section 3).

Edge endpoints pick one quadrant per bit level with probabilities
A, B, C, D; the vertex labels are then permuted and the edge list
shuffled, as the specification's reference code does. Self-loops are
dropped here (the specification lets the graph construction remove
them); duplicate edges are kept and left to each side to remove.
Runs in PyTorch on any device, from one `torch.Generator`.
"""

from __future__ import annotations

import torch


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, seed: int, device="cpu") -> torch.Tensor:
    """[2, M] int64 endpoints (undirected edges, self-loops removed) of
    a SCALE `scale` graph, M <= edgefactor * 2**scale."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n = 1 << scale
    m = edgefactor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = torch.zeros((2, m), dtype=torch.int64, device=device)
    for level in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        ij[0] += ii.to(torch.int64) << level
        ij[1] += jj.to(torch.int64) << level
    perm = torch.randperm(n, generator=gen, device=device)
    ij = perm[ij]
    ij = ij[:, torch.randperm(m, generator=gen, device=device)]
    return ij[:, ij[0] != ij[1]]


def undirected_csr(edges: torch.Tensor, n: int):
    """(indptr [n+1], indices) int64 of the graph with both directions
    of every edge, duplicates removed, neighbours ascending."""
    src = torch.cat([edges[0], edges[1]])
    dst = torch.cat([edges[1], edges[0]])
    key = torch.unique(src * n + dst)
    src, dst = key // n, key % n
    deg = torch.bincount(src, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=edges.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return indptr, dst


def root_candidates(edges: torch.Tensor, n: int) -> torch.Tensor:
    """Vertices of degree >= 1 (self-loops do not count: there are none),
    the search keys Graph500 allows."""
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    return torch.nonzero(deg > 0).reshape(-1)
