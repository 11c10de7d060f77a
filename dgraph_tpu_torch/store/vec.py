"""Vector tablets and brute-force k-NN seed selection (GraphRAG serving).

Port of `dgraph_tpu/store/vec.py`. A float32vector predicate's values
become one `[n, d]` float32 stack (a `VecTablet`), and `similar_to(pred,
k, <vector|uid>)` selects the k ranks of highest dot-product score, ties
broken by the lower rank, as a sorted rank set. Three routes, one
contract (the same rank set):

* host — numpy matmul + lexsort((rank, -score)): the reference's own
  route and the one the others are held to;
* device — `device_topk` on the tablet's tensors (`Store.vec_device`):
  `torch.mv` for the scores, then one exact selection. Each row's key is
  the int64 `(orderable_bits(-score) << 32) | rank`, so every key is
  distinct and `torch.topk(keys, k, largest=False)` selects exactly the
  set the host lexsort does, with no full sort (`-0.0` is made `+0.0`
  and NaN sorts last, as lexsort has them). The whole-block program's
  knn stage (`engine/fused.py`) runs the same function inside its
  graph;
* mesh — `_mesh_topk` on the stack row-sharded over a mesh
  (`Store.vec_sharded`): every shard scores its rows and keeps its k
  best keys, an `all_gather` brings the D·k candidates together and one
  more selection takes the global k (the global top-k is a subset of
  the shards' top-k union). Keys are distinct, so the set is the
  host's. Over a mesh that spans processes each process scores its own
  shards and the gather crosses processes.

The product is a float32 GEMV: cuBLAS runs it in full float32 (TF32
applies to matrix-matrix products, and
`torch.backends.cuda.matmul.allow_tf32` is False by default). As in the
reference, the routes give the same set whenever the scores are equal,
which holds exactly for small-integer-valued vectors (the fixtures').

`similar_ranks` takes the mesh route when a mesh is given, or else the
device route, when the tablet reaches `device_threshold` rows or the
cost priors' measured µs-per-1k-rows EMAs (utils/costprior.py, learned
from every call) say that route beats the host scan; it counts each
route in `knn_route_total{route=}` (host, device, mesh, and fused for a
knn stage of a whole-block program). The device and mesh launches run
under the memory governor's allocation-failure lifecycle at site
`vec.topk` (utils/memgov.py): one evict-and-retry on the card (taken by
every rank together on a mesh across processes), and a second
allocation failure raises; nothing falls back to the host scan.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch.store.types import parse_vector
from dgraph_tpu_torch.ops.uidalgebra import sentinel
from dgraph_tpu_torch.utils import costprior, costprofile, memgov
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["VecQueryError", "VecTablet", "build_tablet", "host_topk",
           "host_similar", "resolve_query", "topk_keys", "device_topk",
           "similar_ranks"]

EMPTY = np.zeros(0, np.int32)



class VecQueryError(ValueError):
    """Typed user error for malformed `similar_to` arguments: a request
    refusal on every route (the whole-block planner leaves such a block
    to the staged route, which raises it). A structurally empty seed (a
    uid without a row) is not an error: it serves the empty set."""


@dataclass
class VecTablet:
    """One predicate's embedding stack: `vecs[i]` is the vector of rank
    `subj[i]` (sorted unique int32 ranks; first value per subject)."""

    subj: np.ndarray   # int32 [n], sorted unique
    vecs: np.ndarray   # float32 [n, d], row-aligned with subj
    dim: int

    @property
    def rows(self) -> int:
        return int(self.subj.shape[0])

    def vector_of(self, rank: int) -> np.ndarray | None:
        i = int(np.searchsorted(self.subj, rank))
        if i < self.rows and int(self.subj[i]) == rank:
            return self.vecs[i]
        return None


def build_tablet(col, dim_hint: int = 0) -> VecTablet:
    """ValueColumn (object column of 1-D f32 rows) → VecTablet. First
    value per subject wins; an empty column yields a [0, dim_hint]
    stack."""
    if col is None or not len(col.subj):
        return VecTablet(subj=EMPTY.copy(),
                         vecs=np.zeros((0, dim_hint), np.float32),
                         dim=dim_hint)
    subj, idx = np.unique(np.asarray(col.subj, np.int32),
                          return_index=True)
    vecs = np.stack([np.asarray(col.vals[i], np.float32)
                     for i in idx]).astype(np.float32, copy=False)
    return VecTablet(subj=subj.astype(np.int32), vecs=vecs,
                     dim=int(vecs.shape[1]))


# -- host route: the reference order ---------------------------------------------

def host_topk(subj: np.ndarray, vecs: np.ndarray, q: np.ndarray,
              k: int) -> np.ndarray:
    """Top-k ranks by dot-product score, ties broken by rank ascending,
    as the SORTED rank set. k > n clamps to n."""
    if not len(subj) or k <= 0:
        return EMPTY.copy()
    scores = vecs @ np.asarray(q, np.float32)
    order = np.lexsort((subj, -scores))
    return np.sort(subj[order[:k]]).astype(np.int32)


def host_similar(store, f) -> np.ndarray:
    """`eval_func`'s similar_to branch: the host route, uncounted."""
    resolved = resolve_query(store, f)
    if resolved is None:
        return EMPTY.copy()
    pred, k, q = resolved
    t = store.vec_tablet(pred)
    return host_topk(t.subj, t.vecs, q, k)


def resolve_query(store, f):
    """FuncNode args → (pred, k, query f32[d]), or None when the seed set
    is structurally empty (no tablet, unknown uid, uid without a row).
    Malformed args and width mismatches raise VecQueryError on every
    route."""
    pred = f.attr
    if len(f.args) != 2:
        raise VecQueryError(
            "similar_to(pred, k, <vector|uid>) takes exactly two "
            "arguments after the predicate")
    k = int(f.args[0])
    if k <= 0:
        raise VecQueryError(f"similar_to k must be positive, got {k}")
    t = store.vec_tablet(pred)
    if t is None or not t.rows:
        return None
    arg = f.args[1]
    if isinstance(arg, (list, tuple, np.ndarray, str)):
        # str: the quoted literal form `"[1, 0, ...]"` from DQL
        try:
            q = parse_vector(arg)
        except ValueError as e:
            raise VecQueryError(str(e)) from e
    elif isinstance(arg, (int, np.integer)):
        rank = int(store.rank_of(np.array([int(arg)], np.int64))[0])
        if rank < 0:
            return None
        q = t.vector_of(rank)
        if q is None:
            return None
    else:
        raise VecQueryError(
            f"similar_to query must be a vector literal or a uid, "
            f"got {arg!r}")
    if len(q) != t.dim:
        raise VecQueryError(
            f"similar_to({pred}): query vector has dim {len(q)}, "
            f"tablet has dim {t.dim}")
    return pred, k, np.asarray(q, np.float32)


# -- device route: scores + one exact selection ---------------------------------

def topk_keys(scores: torch.Tensor, subj: torch.Tensor) -> torch.Tensor:
    """int64 key per row whose ascending order is the host's total order
    (score descending, rank ascending): the orderable int32 bits of
    -score in the high word, the rank in the low word. Distinct ranks
    make every key distinct."""
    neg = -scores + 0.0                  # -0.0 + 0.0 == +0.0
    bits = neg.view(torch.int32)
    # IEEE bits → an int32 whose signed order is the float order
    okey = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    okey = torch.where(torch.isnan(neg), torch.iinfo(torch.int32).max,
                       okey)
    return (okey.to(torch.int64) << 32) | subj.to(torch.int64)


def device_topk(subj: torch.Tensor, vecs: torch.Tensor, q: torch.Tensor,
                k: int, out_cap: int | None = None) -> torch.Tensor:
    """The k best rows of one tablet on its device → their ranks, sorted
    ascending and sentinel-padded to `out_cap` (default min(k, rows)).
    No host synchronisation: k is static and clamps to the rows."""
    rows = subj.shape[0]
    k = min(int(k), rows)
    out_cap = k if out_cap is None else out_cap
    scores = torch.mv(vecs, q)
    idx = torch.topk(topk_keys(scores, subj), k, largest=False,
                     sorted=False).indices
    top = subj[idx]
    if out_cap > k:
        top = torch.cat([top, torch.full((out_cap - k,),
                                         sentinel(subj.dtype),
                                         dtype=subj.dtype,
                                         device=subj.device)])
    return torch.sort(top).values


# -- the routed entry point (Executor._leaf_set) ---------------------------------

def _count(route: str) -> None:
    METRICS.inc("knn_route_total", route=route)


def _device_similar(store, pred: str, q: np.ndarray, k: int, device,
                    shape_key) -> np.ndarray:
    """The device top-k over the placed stack, through the allocation-
    failure lifecycle; an allocation failure its retry does not absorb
    raises."""

    def _launch():
        subj_d, vecs_d = store.vec_device(pred, device)
        q_d = torch.from_numpy(q).to(vecs_d.device)
        t0 = time.perf_counter()
        top = device_topk(subj_d, vecs_d, q_d, k)
        costprofile.note_launch(t0, time.perf_counter())
        return top.cpu().numpy()

    return memgov.oom_retry("vec.topk", shape_key, _launch).astype(
        np.int32, copy=False)


# the key a shard with fewer than k rows pads its candidates with: past
# every real key (a real key's high word is at most INT32_MAX, NaN's)
_NO_KEY = torch.iinfo(torch.int64).max


def _mesh_topk(store, pred: str, q: np.ndarray, k: int, mesh,
               shape_key) -> np.ndarray:
    """The mesh top-k over the row-sharded stack, through the
    allocation-failure lifecycle: each shard's k best keys (`topk_keys`),
    gathered, and the k best of those."""
    from dgraph_tpu_torch.parallel.mesh import (all_gather, program,
                                                replicate)

    def _launch():
        subj_s, vecs_s, rows = store.vec_sharded(pred, mesh)
        # a shard offers at most min(k, rows) candidates; the merge takes
        # up to k across all of them
        kk = min(k, rows)
        k_out = min(k, kk * mesh.size)
        with program(mesh, "knn_mesh"):
            q_r = replicate(mesh, q).parts
            t0 = time.perf_counter()
            cands = [None] * mesh.size
            for d in mesh.local:
                subj, vecs = subj_s.parts[d], vecs_s.parts[d]
                keys = topk_keys(torch.mv(vecs, q_r[d]), subj)
                top = torch.topk(keys, min(kk, keys.shape[0]), largest=False,
                                 sorted=False).values
                pad = kk - top.shape[0]
                cands[d] = (torch.cat([top, top.new_full((pad,), _NO_KEY)])
                            if pad else top)
            keys = all_gather(mesh, cands)[mesh.lead].reshape(-1)
            best = torch.topk(keys, k_out, largest=False, sorted=False).values
            best = best[best != _NO_KEY]
            out = (best & 0xFFFFFFFF).to(torch.int32)
            costprofile.note_launch(t0, time.perf_counter())
            return torch.sort(out).values.cpu().numpy()

    return memgov.oom_retry("vec.topk", shape_key, _launch,
                            mesh=mesh).astype(
        np.int32, copy=False)


def similar_ranks(store, f, device, device_threshold: int = 512,
                  mesh=None) -> np.ndarray:
    """similar_to with route selection and accounting: the mesh top-k
    when a mesh is given, else the device top-k, on a tablet of at least
    `device_threshold` rows (or when the knn route EMAs promote that
    route), the host scan otherwise. A device failure raises."""
    from dgraph_tpu_torch.parallel.mesh import lockstep
    from dgraph_tpu_torch.parallel.mesh import promoted as mesh_promoted

    resolved = resolve_query(store, f)
    if resolved is None:
        return EMPTY.copy()
    pred, k, q = resolved
    t = store.vec_tablet(pred)
    n = t.rows
    t0 = time.perf_counter()
    # while the mesh spans processes the lead's promotion decides: every
    # rank must take the same route (parallel/mesh.py)
    if mesh is not None and (n >= device_threshold or mesh_promoted(
            mesh, "knn_mesh", "knn_host")):
        route = "mesh"
        with lockstep(mesh, "mesh.knn"):
            out = _mesh_topk(store, pred, q, k, mesh, (pred, t.dim, k))
    elif n >= device_threshold or costprior.promoted("knn_device",
                                                     "knn_host"):
        route = "device"
        out = _device_similar(store, pred, q, k, device, (pred, t.dim, k))
    else:
        route = "host"
        out = host_topk(t.subj, t.vecs, q, k)
    _count(route)
    if n:
        costprior.PRIORS.learn_route(
            "knn_" + route, (time.perf_counter() - t0) * 1e6 / n * 1000.0)
    return out


def count_fused() -> None:
    """A knn stage served inside a whole-block program."""
    _count("fused")
