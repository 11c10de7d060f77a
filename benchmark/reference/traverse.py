"""Plain reference of a batch of depth-bounded `@recurse(loop: false)`
traversals: per-lane edge counts, and each hop's row occupancy.

A lane's count is the out-degree mass of every vertex it expands: the
vertices at distance 0 .. depth-1 from its root, each once (Graph500's
"edges traversed" of a depth-bounded search). Frontiers are dense
[n, L] float32 0/1 matrices advanced by one sparse-matrix product per
hop; counts are exact float64 sums of integer degrees. With
`precision="float32"` the counts are summed in float32 instead: the
control, the step below the exact integer counts the configuration
states.
"""

from __future__ import annotations

import warnings

import torch

ROW_CHUNK = 1 << 17    # rows per float64 count product (bounds memory)


def adjacency(indptr: torch.Tensor, indices: torch.Tensor, n: int):
    """The symmetric 0/1 adjacency as a sparse CSR float32 matrix."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            indptr, indices, torch.ones(indices.shape[0],
                                        dtype=torch.float32,
                                        device=indices.device), (n, n),
            check_invariants=False)


def _count(deg: torch.Tensor, front: torch.Tensor, precision: str):
    """Σ_v deg[v]·front[v, q] per lane q."""
    if precision == "float32":
        return deg.to(torch.float32) @ front
    acc = torch.zeros(front.shape[1], dtype=torch.float64,
                      device=front.device)
    for lo in range(0, front.shape[0], ROW_CHUNK):
        hi = min(front.shape[0], lo + ROW_CHUNK)
        acc += deg[lo:hi].to(torch.float64) @ front[lo:hi].to(torch.float64)
    return acc


def lane_counts(adj, deg: torch.Tensor, roots: torch.Tensor, depth: int,
                block: int = 512, precision: str = "float64",
                occupancy: dict | None = None) -> torch.Tensor:
    """Edge counts [len(roots)] int64 (float32 with the float32
    control) of depth-`depth` searches from `roots`, `block` lanes at a
    time. With `occupancy` (a dict), it receives per hop the union over
    all lanes of the rows the hop's frontier occupies (`front`) and of
    the rows first visited (`fresh`), as bool [n] tensors."""
    n = deg.shape[0]
    dev = roots.device
    out = []
    for lo in range(0, roots.shape[0], block):
        r = roots[lo:lo + block]
        lanes = r.shape[0]
        front = torch.zeros((n, lanes), dtype=torch.float32, device=dev)
        front[r, torch.arange(lanes, device=dev)] = 1.0
        seen = front > 0
        cnt = None
        for h in range(depth):
            c = _count(deg, front, precision)
            cnt = c if cnt is None else cnt + c
            if occupancy is not None:
                _union(occupancy, ("front", h), (front > 0).any(1))
            fresh = (adj @ front > 0) & ~seen
            seen |= fresh
            if occupancy is not None:
                _union(occupancy, ("fresh", h), fresh.any(1))
            front = fresh.to(torch.float32)
        out.append(cnt)
        del front, seen
    counts = torch.cat(out) if out else torch.zeros(0, device=dev)
    return counts if precision == "float32" else counts.round().to(
        torch.int64)


def _union(acc: dict, key, rows: torch.Tensor) -> None:
    acc[key] = rows if key not in acc else acc[key] | rows


def hop_occupancy(adj, deg: torch.Tensor, roots: torch.Tensor, depth: int,
                  block: int = 512) -> list[dict]:
    """Per hop of one batch (all its lanes): occupied frontier rows, rows
    whose OR has bits (an in-neighbour occupied), first-visited rows, and
    occupied slots (edges out of occupied rows)."""
    occ: dict = {}
    lane_counts(adj, deg, roots, depth, block, occupancy=occ)
    hops = []
    for h in range(depth):
        front = occ[("front", h)]
        nxt = (adj @ front.to(torch.float32).reshape(-1, 1)).reshape(-1) > 0
        hops.append({"occupied_rows": int(front.sum()),
                     "nxt_rows": int(nxt.sum()),
                     "fresh_rows": int(occ[("fresh", h)].sum()),
                     "occupied_slots": int(deg[front].sum())})
    return hops
