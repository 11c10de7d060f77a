"""Set-up of a Graph500 graph in the port, for lane-packed traversal.

The Kronecker edge list (`reference/kronecker.py`, made on the device
from the seed) is loaded into the port's store as one `[uid]` predicate
holding both directions of every edge (uid = vertex + 1, every vertex
touched, so the rank space is the graph's); the port's CSR removes the
duplicate edges. Then `ops/bfs.build_ell` on the relation's CSR,
`device_ell`, and the recurse and count closures at the traffic's lane
width. The reference side keeps the host copy of the edge list only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import kronecker, traverse


class Inputs:
    """The generated graph: the edge list on the host and the roots
    Graph500 allows (degree >= 1)."""

    def __init__(self, cfg: dict, seed: int, device: str):
        t0 = time.perf_counter()
        self.device = device
        self.n = 1 << int(cfg["scale"])
        edges = kronecker.kronecker_edges(
            int(cfg["scale"]), int(cfg["edgefactor"]), float(cfg["A"]),
            float(cfg["B"]), float(cfg["C"]), seed, device)
        self.candidates = kronecker.root_candidates(edges,
                                                    self.n).cpu().numpy()
        self.edges = edges.cpu().numpy()
        self.phases = {"generate_s": time.perf_counter() - t0}


class Lanes(Inputs):
    """The generated graph loaded into the port."""

    def __init__(self, cfg: dict, seed: int, device: str, lanes: int):
        from dgraph_tpu_torch.ops import bfs
        from dgraph_tpu_torch.store.schema import parse_schema
        from dgraph_tpu_torch.store.store import StoreBuilder

        super().__init__(cfg, seed, device)
        t0 = time.perf_counter()
        src = np.concatenate([self.edges[0], self.edges[1]]) + 1
        dst = np.concatenate([self.edges[1], self.edges[0]]) + 1
        b = StoreBuilder(parse_schema(f"{cfg['predicate']}: [uid] ."))
        b.add_edges(cfg["predicate"], src, dst)
        b.touch_many(np.arange(1, self.n + 1, dtype=np.int64))
        del src, dst
        store = b.finalize()
        rel = store.rel(cfg["predicate"])
        self.nnz = int(rel.indices.shape[0])
        t1 = time.perf_counter()
        self.g = bfs.build_ell(rel.indptr, rel.indices)
        del store, rel, b
        t2 = time.perf_counter()
        if self.g.n != self.n:
            raise ValueError(f"store holds {self.g.n} vertices, want {self.n}")
        self.words = lanes // 32
        dev = bfs.device_ell(self.g, device)
        self.recurse = bfs.make_ell_recurse(dev, self.g.outdeg, self.g.n,
                                            self.words, count_edges=False)
        self.count = bfs.make_ell_count(self.g.outdeg, self.g.n, device)
        self._bfs = bfs
        self.phases.update(store_s=t1 - t0, build_ell_s=t2 - t1,
                           device_s=time.perf_counter() - t2)

    def pack(self, roots: np.ndarray):
        """Host seed mask: lane q starts at vertex roots[q]."""
        return self._bfs.pack_seed_masks(self.g, roots.reshape(-1, 1))

    def put(self, mask):
        return self._bfs.put_mask(mask, self.device)

    def free(self) -> None:
        """Drop the program's state (the host edge list stays)."""
        self.recurse = self.count = self.g = self._bfs = None


class Reference:
    """The plain reference over the same edge list, on `device`."""

    def __init__(self, edges: np.ndarray, n: int, device: str):
        e = torch.as_tensor(edges, device=device)
        indptr, indices = kronecker.undirected_csr(e, n)
        del e
        self.deg = indptr[1:] - indptr[:-1]
        self.nnz = int(indices.shape[0])
        self.adj = traverse.adjacency(indptr, indices, n)
        self.device = device

    def counts(self, roots: np.ndarray, depth: int,
               precision: str = "float64") -> np.ndarray:
        r = torch.as_tensor(roots, device=self.device)
        return traverse.lane_counts(self.adj, self.deg, r, depth,
                                    precision=precision).cpu().numpy()

    def occupancy(self, roots: np.ndarray, depth: int) -> list:
        r = torch.as_tensor(roots, device=self.device)
        return traverse.hop_occupancy(self.adj, self.deg, r, depth)


def build(cfg: dict, seed: int, device: str, traffic: dict) -> Lanes:
    return Lanes(cfg, seed, device, int(traffic["lanes"]))


def reference(system: Inputs, device: str) -> Reference:
    return Reference(system.edges, system.n, device)
