"""Vector tablets and brute-force k-NN seed selection (GraphRAG serving).

Port of `dgraph_tpu/store/vec.py` without its mesh route (ROADMAP Queue 1
item 10) and its memory-governor wrapper and cost-prior promotion (item
9). A float32vector predicate's values become one `[n, d]` float32 stack
(a `VecTablet`), and `similar_to(pred, k, <vector|uid>)` selects the k
ranks of highest dot-product score, ties broken by the lower rank, as a
sorted rank set. Two routes, one contract (the same rank set):

* host — numpy matmul + lexsort((rank, -score)): the reference's own
  route and the one the others are held to;
* device — `device_topk` on the tablet's tensors (`Store.vec_device`):
  `torch.mv` for the scores, then one exact selection. Each row's key is
  the int64 `(orderable_bits(-score) << 32) | rank`, so every key is
  distinct and `torch.topk(keys, k, largest=False)` selects exactly the
  set the host lexsort does, with no full sort (`-0.0` is made `+0.0`
  and NaN sorts last, as lexsort has them). The whole-block program's
  knn stage (`engine/fused.py`) runs the same function inside its
  graph.

The product is a float32 GEMV: cuBLAS runs it in full float32 (TF32
applies to matrix-matrix products, and
`torch.backends.cuda.matmul.allow_tf32` is False by default). As in the
reference, the routes give the same set whenever the scores are equal,
which holds exactly for small-integer-valued vectors (the fixtures').

`similar_ranks` picks the route by `device_threshold` alone (tablet rows)
and counts each route in `status()`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch.store.types import parse_vector
from dgraph_tpu_torch.ops.uidalgebra import sentinel

__all__ = ["VecQueryError", "VecTablet", "build_tablet", "host_topk",
           "host_similar", "resolve_query", "topk_keys", "device_topk",
           "similar_ranks", "status", "reset"]

EMPTY = np.zeros(0, np.int32)

_lock = threading.Lock()
_routes = {"host": 0, "device": 0, "fused": 0}


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
    with _lock:
        _routes[route] += 1


def similar_ranks(store, f, device, device_threshold: int = 512
                  ) -> np.ndarray:
    """similar_to with route selection and accounting: the device top-k
    on a tablet of at least `device_threshold` rows, the host scan
    otherwise. A device failure raises."""
    resolved = resolve_query(store, f)
    if resolved is None:
        return EMPTY.copy()
    pred, k, q = resolved
    t = store.vec_tablet(pred)
    if t.rows >= device_threshold:
        subj_d, vecs_d = store.vec_device(pred, device)
        q_d = torch.from_numpy(q).to(vecs_d.device)
        out = device_topk(subj_d, vecs_d, q_d, k).cpu().numpy()
        _count("device")
        return out.astype(np.int32, copy=False)
    _count("host")
    return host_topk(t.subj, t.vecs, q, k)


def count_fused() -> None:
    """A knn stage served inside a whole-block program."""
    _count("fused")


def status() -> dict:
    """similar_to seeds served per route since the last `reset()`."""
    with _lock:
        return {"routes": dict(_routes)}


def reset() -> None:
    with _lock:
        for r in _routes:
            _routes[r] = 0
