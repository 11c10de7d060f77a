"""Distributed order-by: per-shard top-k and a merge on the mesh.

Port of `dgraph_tpu/parallel/dsort.py`. Every shard ranks the candidates
living in its row slab against a dense sort-key column, takes its local
top-k, and an `all_gather` plus a second sort merge them into the global
top-k (`mesh_topk`; the host reads the merge of this process's first
shard); a child
level's edges sort by (row, key, uid) against the same column, each
shard contributing the keys of the ranks it owns through a `psum`
(`mesh_row_sort`).

Keys are float64, +inf for a missing value (missing sorts last, as the
reference has it), negated for descending order; ties break by rank
ascending. Deliberate difference: the reference's column is float32
(JAX's default 32-bit mode casts the float64 host column on placement),
so values closer than float32 resolution (datetimes in µs) tie there
and fall back to rank order; here they order by value, as the host
route of either package orders them. The reference's `jnp.lexsort` becomes stable sorts from the
least significant key up. String values ride a rank-dictionary code
column (`_string_codes`); a column that is not orderable (`None`) leaves
the order to the host.

The key columns are cached on the store per (predicate, lang) for one
mesh (`store._key_cols`, reset when `store._key_cols_mesh` is another
mesh). An ACL view shares its snapshot's columns of the predicates it
reads (`Store.key_col_host`, `server/acl.py`); a column it builds for a
hidden predicate (an empty one) stays on the view.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch.ops.uidalgebra import SENTINEL32, sentinel, valid_mask
from dgraph_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                            count_program, psum, replicate,
                                            shard)

__all__ = ["mesh_topk", "mesh_row_sort", "valid_mask_np"]

INT32_MAX = 2**31 - 1


def _lexsort(keys) -> torch.Tensor:
    """The permutation `jnp.lexsort(keys)` gives: the LAST key is the
    primary one; ties keep their order (stable sorts, least significant
    key first)."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _key_column(store, pred: str, lang: str, mesh: Mesh):
    """The dense float64 sort-key column of `pred` sharded over the mesh
    (row slab d on shard d), cached on the store: (keys Sharded [D][rows],
    row_lo [D] host, rows). None when the values are not numerically
    orderable (the host sorts them)."""
    pick = getattr(store, "key_col_host", None)
    host = pick(pred) if pick is not None else store
    cache = getattr(host, "_key_cols", None)
    if cache is None or getattr(host, "_key_cols_mesh", None) is not mesh:
        cache = {}
        host._key_cols = cache
        host._key_cols_mesh = mesh
    ck = (pred, lang)
    if ck in cache:
        return cache[ck]
    col = store.value_col(pred, lang)
    result = None
    if col is not None and len(col.subj):
        vals = col.vals
        if vals.dtype == object:
            first = next((v for v in vals if v is not None), None)
            if isinstance(first, (bool, np.bool_, int, np.integer, float,
                                  np.floating, np.datetime64)):
                vals = np.array([_to_key(v) for v in vals], np.float64)
            elif isinstance(first, str):
                vals = _string_codes(np.array([str(v) for v in vals]))
            else:
                vals = None
        elif vals.dtype.kind == "U":
            vals = _string_codes(vals)
        elif np.issubdtype(vals.dtype, np.datetime64):
            vals = vals.astype("datetime64[us]").astype(np.int64
                                                        ).astype(np.float64)
        elif np.issubdtype(vals.dtype, np.number) or vals.dtype == bool:
            vals = vals.astype(np.float64)
        else:
            vals = None
        if vals is not None:
            n = store.n_nodes
            d = mesh.size
            rows = -(-max(n, 1) // d)
            dense = np.full(d * rows, np.inf)     # missing → last
            # first value per subject wins (col.subj sorted; keep first)
            subj, idx = np.unique(col.subj, return_index=True)
            dense[subj] = vals[idx]
            keys_s = shard(mesh, dense.reshape(d, rows))
            row_lo = np.arange(d, dtype=np.int32) * rows
            result = (keys_s, row_lo, rows)
    cache[ck] = result
    return result


def _to_key(v) -> float:
    if isinstance(v, np.datetime64):
        return float(v.astype("datetime64[us]").astype("int64"))
    return float(v)


def _string_codes(svals: np.ndarray) -> np.ndarray | None:
    """Rank-dictionary encoding: dense codes of the sorted unique strings
    order exactly like the strings, so string order-by runs on the
    float column (the dictionary stays on the host). Dictionaries of
    2^24 strings or more stay on the host, as in the reference."""
    uniq, codes = np.unique(svals, return_inverse=True)
    if len(uniq) >= 1 << 24:
        return None
    return codes.astype(np.float64)


def _bucket(n: int) -> int:
    cap = 64
    # graftlint: allow(hot-loop-checkpoint): O(log n) shift arithmetic
    while cap < n:
        cap <<= 1
    return cap


def _pad(a: np.ndarray, cap: int) -> np.ndarray:
    out = np.full(cap, SENTINEL32, np.int32)
    out[:len(a)] = a
    return out


def mesh_topk(mesh: Mesh, store, pred: str, lang: str, ranks: np.ndarray,
              k: int, desc: bool = False) -> np.ndarray | None:
    """Global top-k of `ranks` ordered by a value predicate, on the mesh:
    the ordered rank array (missing-valued ranks last), or None when the
    key column is not orderable on the device."""
    col = _key_column(store, pred, lang, mesh)
    if col is None:
        return None
    count_program("mesh_topk")
    keys_s, row_lo, rows = col
    cap = _bucket(len(ranks))
    cand = replicate(mesh, _pad(np.asarray(ranks, np.int32), cap)).parts
    # full-length sorts (no `first`) take kk = cap, as the reference
    kk = cap if k >= len(ranks) else min(k, cap)
    tops_r, tops_v = [None] * mesh.size, [None] * mesh.size
    for d in mesh.local:
        keys = keys_s.parts[d]
        if desc:
            # negate finite keys only: missing (+inf) still sorts last
            keys = torch.where(torch.isinf(keys), keys, -keys)
        c = cand[d]
        local = c - int(row_lo[d])
        mine = valid_mask(c) & (local >= 0) & (local < rows)
        ck = torch.where(mine, keys[local.clamp(0, rows - 1).long()],
                         torch.inf)
        # candidates another shard owns drop out entirely: a sentinel
        # rank sorts after every real row, missing-valued ones included
        cand_m = torch.where(mine, c, sentinel(c.dtype))
        order = _lexsort((cand_m, ck))[:kk]
        tops_r[d] = cand_m[order]
        tops_v[d] = ck[order]
    gr = all_gather(mesh, tops_r)[mesh.lead].reshape(-1)
    gv = all_gather(mesh, tops_v)[mesh.lead].reshape(-1)
    top_r = gr[_lexsort((gr, gv))[:kk]].cpu().numpy()
    out = top_r[valid_mask_np(top_r)]
    return out[:min(k, len(ranks))]


def valid_mask_np(a: np.ndarray) -> np.ndarray:
    return a != SENTINEL32


def mesh_row_sort(mesh: Mesh, store, pred: str, lang: str,
                  nbrs: np.ndarray, seg: np.ndarray,
                  desc: bool = False) -> np.ndarray | None:
    """Per-row (child-level) order-by on the mesh: the whole edge list
    sorted by (row, key, uid) against the sharded key column, each rank's
    key from the one shard that owns it (a psum). Returns the
    permutation, or None when the column is not orderable."""
    col = _key_column(store, pred, lang, mesh)
    if col is None:
        return None
    count_program("mesh_row_sort")
    keys_s, row_lo, rows = col
    cap = _bucket(len(nbrs))
    nb = replicate(mesh, _pad(np.asarray(nbrs, np.int32), cap)).parts
    # pad_to's padding: seg's pad value never matters (valid_mask(nbrs)
    # masks the padded slots)
    sg = replicate(mesh, _pad(np.asarray(seg, np.int32), cap)).parts
    parts = [None] * mesh.size
    for d in mesh.local:
        local = nb[d] - int(row_lo[d])
        mine = valid_mask(nb[d]) & (local >= 0) & (local < rows)
        parts[d] = torch.where(
            mine, keys_s.parts[d][local.clamp(0, rows - 1).long()], 0.0)
    # every valid rank lives on exactly ONE shard: the psum assembles the
    # full per-edge key vector
    lead = mesh.lead
    kv = psum(mesh, parts)[lead]
    n0, s0 = nb[lead], sg[lead]
    if desc:
        kv = torch.where(torch.isinf(kv), kv, -kv)
    # padded slots sort last within their (nonexistent) row
    kv = torch.where(valid_mask(n0), kv, torch.inf)
    seg_k = torch.where(valid_mask(n0), s0, INT32_MAX)
    # priority: row, key (missing=+inf last), uid tiebreak
    order = _lexsort((n0, kv, seg_k)).cpu().numpy()
    # padded slots carry a maxint row key, so they sort strictly last
    return order[:len(nbrs)]

