"""Synthetic graph workload generators (benchmark fixtures).

Port of `dgraph_tpu/models/synthetic.py` (`powerlaw_edges`,
`powerlaw_rel`): the same numpy draws from the same seed, so the port
builds the bench graph bit-identically without loading jax.
"""

from __future__ import annotations

import numpy as np

from dgraph_tpu_torch.store.store import EdgeRel, _csr_from_pairs


def powerlaw_edges(n_nodes: int, avg_deg: float, seed: int = 0,
                   zipf_a: float = 2.0) -> tuple[np.ndarray, np.ndarray]:
    """Directed edges with Zipf-distributed out-degree and preferential
    (rank-skewed) destinations. Returns (src, dst) int64 arrays with
    self-loops removed; duplicate pairs may remain (CSR construction
    dedupes them)."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(zipf_a, size=n_nodes)
    # cap the tail, then rescale to hit the requested average degree
    deg = np.minimum(deg, max(int(avg_deg * 64), 8))
    deg = np.maximum((deg * (avg_deg / max(deg.mean(), 1e-9))).astype(np.int64), 0)
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), deg)
    # destinations skewed toward low ranks (hubs), like follower graphs
    dst = (n_nodes * rng.beta(0.6, 1.8, size=src.shape[0])).astype(np.int64)
    dst = np.minimum(dst, n_nodes - 1)
    keep = src != dst
    return src[keep], dst[keep]


def powerlaw_rel(n_nodes: int, avg_deg: float, seed: int = 0) -> EdgeRel:
    """A deduped CSR relation over ranks [0, n_nodes) (uid == rank here)."""
    src, dst = powerlaw_edges(n_nodes, avg_deg, seed)
    return _csr_from_pairs(src.astype(np.int32), dst.astype(np.int32), n_nodes)
