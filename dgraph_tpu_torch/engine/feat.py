"""Feature-bearing traversal: `@msgpass` neighbour aggregation.

Port of `dgraph_tpu/engine/feat.py`. `@msgpass(pred: emb, agg: mean)`
on a block binds, for each node the level expands, the sum / mean / max
of its traversal children's feature rows (a `store/vec.py` VecTablet),
rendered under the key `mean(emb)`. Composed with `@recurse(loop:
false)` each parent aggregates over its first-visit edges. Three routes,
one contract (the same `[d]` f32 bindings):

* host — `host_combine`, numpy `add.at` / `maximum.at` over the kept-edge
  lists: the reference's own route;
* device — `ops/feat.py:segment_combine` on the tablet's tensors, the
  hand kernel on the card, which sums in edge order and so equals the
  host route bit for bit for any float input;
* mesh — `_mesh_combine` on the stack row-sharded over a mesh
  (`Store.vec_sharded`): every shard runs `segment_combine` (the hand
  kernel on the card) over the edges whose neighbour has a row in its
  slab, and the partials merge by `psum` (sums, counts) or `pmax`
  (maxima; a shard without a participant in a segment offers -inf
  there), the mean dividing once after the merge. Each row lives on one
  shard, so counts and max are exact, and sum and mean differ from the
  edge-order sum only by the shard-order addition of the partials (the
  reference's psum likewise). Over a mesh that spans processes each
  process runs the kernel for its own shards and the merge gathers
  every shard's partial before it adds them in shard order, so the
  answer is the single-process mesh's bit for bit.

`aggregate` takes the mesh route when a mesh is given, or else the
device route, when the edges or the tablet rows reach
`device_threshold` or the cost priors' feat route EMAs
(utils/costprior.py) say that route beats the host. The device and
mesh launches run under the memory governor's allocation-failure
lifecycle at site `feat.agg` (utils/memgov.py): one evict-and-retry on
the card, and a second allocation failure raises; nothing falls back to
the host combine. It counts each route
in the metrics registry
(`feat_route_total{route=}`, `feat_bytes_total`, the
`featprop_latency_us` histogram); the whole-block program's featprop
stage (`engine/fused.py`) counts as `fused`.
Aggregation is per EDGE over each level's kept-edge lists (duplicates
count), the lists the renderer emits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dgraph_tpu_torch.ops.feat import AGGS, segment_combine
from dgraph_tpu_torch.utils import costprior, costprofile, memgov
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["AGGS", "host_combine", "aggregate", "annotate_tree",
           "needs_msgpass", "feat_key"]

EMPTY = np.zeros(0, np.int32)

def feat_key(args) -> str:
    """JSON key of the bound value: `mean(emb)`, as `count(friend)`."""
    return f"{args.agg}({args.pred})"


def count_route(route: str, participating: int, dim: int,
                us: float) -> None:
    """One aggregation served on `route`, reading `participating` rows of
    `dim` floats, in `us` microseconds of host time."""
    METRICS.inc("feat_route_total", route=route)
    if participating:
        METRICS.inc("feat_bytes_total", float(int(participating) * dim * 4))
    METRICS.observe("featprop_latency_us", us)


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
                    device, shape_key):
    """The device combine through the allocation-failure lifecycle; an
    allocation failure its retry does not absorb raises."""
    nb = torch.from_numpy(np.ascontiguousarray(nbrs, np.int32))
    sg = torch.from_numpy(np.ascontiguousarray(seg, np.int32))

    def _launch():
        subj_d, vecs_d = store.vec_device(pred, device)
        cols = torch.stack([nb, sg]).to(vecs_d.device)
        t0 = time.perf_counter()
        out, cnt, ecnt = segment_combine(subj_d, vecs_d, cols[0], cols[1],
                                         len(nbrs), n_seg, agg)
        costprofile.note_launch(t0, time.perf_counter())
        return (out.cpu().numpy(), cnt.cpu().numpy(), ecnt.cpu().numpy())

    return memgov.oom_retry("feat.agg", shape_key, _launch)


def _mesh_combine(store, pred: str, nbrs, seg, n_seg: int, agg: str,
                  mesh, shape_key):
    """The mesh combine through the allocation-failure lifecycle:
    per-shard partials merged by psum / pmax (see the module doc)."""
    from dgraph_tpu_torch.parallel.mesh import (count_program, pmax, psum,
                                                replicate)
    nb = np.ascontiguousarray(nbrs, np.int32)
    sg = np.ascontiguousarray(seg, np.int32)
    part_agg = "max" if agg == "max" else "sum"

    def _launch():
        subj_s, vecs_s, _rows = store.vec_sharded(pred, mesh)
        count_program("feat_mesh")
        cols = replicate(mesh, np.stack([nb, sg])).parts
        t0 = time.perf_counter()
        outs, cnts, ecnt = [None] * mesh.size, [None] * mesh.size, None
        for d in mesh.local:
            subj, vecs = subj_s.parts[d], vecs_s.parts[d]
            if subj.shape[0]:
                out, cnt, ec = segment_combine(subj, vecs, cols[d][0],
                                               cols[d][1], len(nb), n_seg,
                                               part_agg)
                ecnt = ec if ecnt is None else ecnt
            else:
                out = vecs.new_zeros((n_seg, vecs.shape[1]))
                cnt = torch.zeros(n_seg, dtype=torch.int32,
                                  device=vecs.device)
            if agg == "max":
                # no participant on this shard: offer -inf to the pmax
                out = torch.where((cnt > 0)[:, None], out, -torch.inf)
            outs[d] = out
            cnts[d] = cnt
        lead = mesh.lead
        cnt = psum(mesh, cnts)[lead]
        if agg == "max":
            out = pmax(mesh, outs)[lead]
            out = torch.where((cnt > 0)[:, None], out, 0.0)
        else:
            out = psum(mesh, outs)[lead]
            if agg == "mean":
                out = torch.where(
                    (cnt > 0)[:, None],
                    out / cnt.clamp(min=1)[:, None].to(torch.float32), 0.0)
        costprofile.note_launch(t0, time.perf_counter())
        # the live edges per segment do not depend on the rows: any
        # shard's count is the structural one
        ecnt = (ecnt.cpu().numpy() if ecnt is not None else np.bincount(
            sg[(sg >= 0) & (sg < n_seg)], minlength=n_seg).astype(np.int32))
        return out.cpu().numpy(), cnt.cpu().numpy(), ecnt

    return memgov.oom_retry("feat.agg", shape_key, _launch,
                            retry=not mesh.spans_processes)


def aggregate(store, pred: str, agg: str, nbrs, seg, n_seg: int, device,
              device_threshold: int = 512, mesh=None):
    """Combine one level's kept-edge feature rows with route selection
    and accounting: the mesh when one is given, else the device, when
    the edges or the tablet rows reach `device_threshold` (or the feat
    route EMAs promote that route), the host otherwise. Returns
    (out[n_seg, d] f32, cnt[n_seg] i32, ecnt[n_seg] i32)."""
    t = store.vec_tablet(pred)
    if t is None:
        raise ValueError(
            f"@msgpass(pred: {pred}): not a float32vector predicate")
    work = len(nbrs)
    t0 = time.perf_counter()
    big = work >= device_threshold or t.rows >= device_threshold
    # while the mesh spans processes only the sizes choose it: every
    # rank must take the same route (parallel/mesh.py)
    if mesh is not None and t.rows and (
            big or (not mesh.spans_processes
                    and costprior.promoted("feat_mesh", "feat_host"))):
        route = "mesh"
        out = _mesh_combine(store, pred, nbrs, seg, n_seg, agg, mesh,
                            (pred, t.dim, agg))
    elif t.rows and (big or costprior.promoted("feat_device",
                                               "feat_host")):
        route = "device"
        out = _device_combine(store, pred, nbrs, seg, n_seg, agg,
                              device, (pred, t.dim, agg))
    else:
        route = "host"
        out = host_combine(t.subj, t.vecs, nbrs, seg, n_seg, agg)
    us = (time.perf_counter() - t0) * 1e6
    count_route(route, int(out[1].sum()), t.dim, us)
    if work:
        costprior.PRIORS.learn_route("feat_" + route, us / work * 1000.0)
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
                                 n, ex.device, ex.device_threshold,
                                 mesh=ex.mesh)
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
                                  ex.device, ex.device_threshold,
                                  mesh=ex.mesh)
    # every unique parent has at least one kept edge by construction
    data.feat_vals = {int(r): np.asarray(vals[i], np.float32)
                      for i, r in enumerate(uniq.tolist())}
