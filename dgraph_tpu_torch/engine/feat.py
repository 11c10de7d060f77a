"""Feature-bearing traversal: `@msgpass` neighbour aggregation.

Port of `dgraph_tpu/engine/feat.py` without its mesh route (ROADMAP
Queue 1 item 10) and its memory-governor wrapper, cost-prior promotion
and metrics (item 9). `@msgpass(pred: emb, agg: mean)` on a block binds,
for each node the level expands, the sum / mean / max of its traversal
children's feature rows (a `store/vec.py` VecTablet), rendered under the
key `mean(emb)`. Composed with `@recurse(loop: false)` each parent
aggregates over its first-visit edges. Two routes, one contract (the same
`[d]` f32 bindings):

* host — `host_combine`, numpy `add.at` / `maximum.at` over the kept-edge
  lists: the reference's own route;
* device — `ops/feat.py:segment_combine` on the tablet's tensors, the
  hand kernel on the card, which sums in edge order and so equals the
  host route bit for bit for any float input.

`aggregate` takes the device route when the edges or the tablet rows
reach `device_threshold`, and counts each route in `status()`; the whole-
block program's featprop stage (`engine/fused.py`) counts as `fused`.
Aggregation is per EDGE over each level's kept-edge lists (duplicates
count), the lists the renderer emits.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from dgraph_tpu_torch.ops.feat import AGGS, segment_combine

__all__ = ["AGGS", "host_combine", "aggregate", "annotate_tree",
           "needs_msgpass", "feat_key", "status", "reset"]

EMPTY = np.zeros(0, np.int32)

_lock = threading.Lock()
_stats = {"routes": {"host": 0, "device": 0, "fused": 0}, "feature_bytes": 0}


def feat_key(args) -> str:
    """JSON key of the bound value: `mean(emb)`, as `count(friend)`."""
    return f"{args.agg}({args.pred})"


def count_route(route: str, participating: int, dim: int) -> None:
    """One aggregation served on `route`, reading `participating` rows of
    `dim` floats."""
    with _lock:
        _stats["routes"][route] += 1
        _stats["feature_bytes"] += int(participating) * dim * 4


def status() -> dict:
    """Aggregations per route and feature bytes read, since `reset()`."""
    with _lock:
        return {"routes": dict(_stats["routes"]),
                "feature_bytes": _stats["feature_bytes"]}


def reset() -> None:
    with _lock:
        for r in _stats["routes"]:
            _stats["routes"][r] = 0
        _stats["feature_bytes"] = 0


# -- host route: the reference -------------------------------------------------

def host_combine(subj: np.ndarray, vecs: np.ndarray, nbrs: np.ndarray,
                 seg: np.ndarray, n_seg: int, agg: str):
    """Numpy combine, sequential in edge order. Same contract as
    `ops/feat.segment_combine`: (out[n_seg, d] f32, cnt[n_seg] i32,
    ecnt[n_seg] i32)."""
    nbrs = np.asarray(nbrs, np.int32)
    seg = np.asarray(seg, np.int64)
    rows, d = int(subj.shape[0]), int(vecs.shape[1])
    if rows:
        idx = np.minimum(np.searchsorted(subj, nbrs), rows - 1)
        has = subj[idx] == nbrs
    else:
        idx = np.zeros(len(nbrs), np.int64)
        has = np.zeros(len(nbrs), bool)
    cnt = np.bincount(seg[has], minlength=n_seg).astype(np.int32)
    ecnt = np.bincount(seg, minlength=n_seg).astype(np.int32)
    if agg == "max":
        out = np.full((n_seg, d), -np.inf, np.float32)
        np.maximum.at(out, seg[has], vecs[idx[has]])
        out = np.where((cnt > 0)[:, None], out, np.float32(0))
    else:
        out = np.zeros((n_seg, d), np.float32)
        np.add.at(out, seg[has], vecs[idx[has]])
        if agg == "mean":
            out = np.where(
                (cnt > 0)[:, None],
                out / np.maximum(cnt, 1)[:, None].astype(np.float32),
                np.float32(0))
    return out.astype(np.float32, copy=False), cnt, ecnt


# -- device route --------------------------------------------------------------

def _device_combine(store, pred: str, nbrs, seg, n_seg: int, agg: str,
                    device):
    subj_d, vecs_d = store.vec_device(pred, device)
    nb = torch.from_numpy(np.ascontiguousarray(nbrs, np.int32))
    sg = torch.from_numpy(np.ascontiguousarray(seg, np.int32))
    cols = torch.stack([nb, sg]).to(vecs_d.device)
    out, cnt, ecnt = segment_combine(subj_d, vecs_d, cols[0], cols[1],
                                     len(nbrs), n_seg, agg)
    return (out.cpu().numpy(), cnt.cpu().numpy(), ecnt.cpu().numpy())


def aggregate(store, pred: str, agg: str, nbrs, seg, n_seg: int, device,
              device_threshold: int = 512):
    """Combine one level's kept-edge feature rows with route selection
    and accounting: the device when the edges or the tablet rows reach
    `device_threshold`, the host otherwise. Returns (out[n_seg, d] f32,
    cnt[n_seg] i32, ecnt[n_seg] i32)."""
    t = store.vec_tablet(pred)
    if t is None:
        raise ValueError(
            f"@msgpass(pred: {pred}): not a float32vector predicate")
    big = len(nbrs) >= device_threshold or t.rows >= device_threshold
    if t.rows and big:
        route = "device"
        out = _device_combine(store, pred, nbrs, seg, n_seg, agg, device)
    else:
        route = "host"
        out = host_combine(t.subj, t.vecs, nbrs, seg, n_seg, agg)
    count_route(route, int(out[1].sum()), t.dim)
    return out


# -- the executor post-pass: bind features onto a finished level tree ---------

def needs_msgpass(sg) -> bool:
    """Whether any block in the subtree carries `@msgpass`."""
    if sg.msgpass is not None:
        return True
    return any(needs_msgpass(c) for c in sg.children)


def annotate_tree(ex, node) -> None:
    """Walk a finished LevelNode tree and bind `feat_vals` (rank →
    f32[d]) wherever the block carries `@msgpass`. Levels the fused
    featprop stage already bound are left as they are: it aggregates
    the same kept-edge lists, so either binding renders the same."""
    args = node.sg.msgpass
    if args is not None:
        if node.sg.recurse is not None and node.sg.recurse.loop:
            raise ValueError(
                "@msgpass composes with @recurse(loop: false) only: "
                "visit-once expansion gives each node exactly one "
                "aggregation hop")
        if node.recurse_data is not None:
            if node.recurse_data.feat_vals is None:
                _annotate_recurse(ex, node, args)
        elif node.feat_vals is None:
            _annotate_level(ex, node, args)
    for ch in node.children:
        annotate_tree(ex, ch)


def _annotate_level(ex, node, args) -> None:
    """Plain (non-recurse) level: aggregate over the concatenated
    kept-edge matrices of every child predicate."""
    node.feat_key = feat_key(args)
    n = len(node.nodes)
    if not n:
        node.feat_vals = {}
        return
    segs = [ch.matrix_seg for ch in node.children if len(ch.matrix_seg)]
    childs = [ch.matrix_child for ch in node.children
              if len(ch.matrix_seg)]
    nbrs = np.concatenate(childs) if childs else EMPTY
    seg = np.concatenate(segs) if segs else EMPTY
    vals, _cnt, ecnt = aggregate(ex.store, args.pred, args.agg, nbrs, seg,
                                 n, ex.device, ex.device_threshold)
    nodes = np.asarray(node.nodes)
    node.feat_vals = {int(nodes[i]): np.asarray(vals[i], np.float32)
                      for i in np.nonzero(ecnt > 0)[0].tolist()}


def _annotate_recurse(ex, node, args) -> None:
    """@recurse level: aggregate over the whole visit-once edge set (each
    parent expands at exactly one hop, so the global combine equals the
    fused stage's per-hop combine)."""
    data = node.recurse_data
    data.feat_key = feat_key(args)
    parts_p, parts_c = [], []
    for i in sorted(data.edges):
        p, c = data.edges[i]
        if len(p):
            parts_p.append(np.asarray(p, np.int32))
            parts_c.append(np.asarray(c, np.int32))
    if not parts_p:
        data.feat_vals = {}
        return
    parents = np.concatenate(parts_p)
    childs = np.concatenate(parts_c)
    uniq, seg = np.unique(parents, return_inverse=True)
    vals, _cnt, _ecnt = aggregate(ex.store, args.pred, args.agg, childs,
                                  seg.astype(np.int32), len(uniq),
                                  ex.device, ex.device_threshold)
    # every unique parent has at least one kept edge by construction
    data.feat_vals = {int(r): np.asarray(vals[i], np.float32)
                      for i, r in enumerate(uniq.tolist())}
