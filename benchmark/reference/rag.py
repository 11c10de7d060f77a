"""Plain reference of the GraphRAG retrieval mix over SNB data.

Everything is worked out again from the generated arrays
(`reference/snb.py`): the k-NN seeds by a float64 scan of the whole
tablet, and what each template renders below its seeds (creator and
first name, tags, the visit-once `@recurse` tree, the `@msgpass` mean)
by plain Python over the generated edge lists.

A served answer is judged in two parts:

* its k-NN seed set, by the widest gap by which a served seed's exact
  score lies below the exact k-th best score, as a share of
  |query| x the tablet's RMS row norm. A near-tie that rounding decides
  either way reads a gap of the order of the rounding, not a fault;
* the rest of the answer, built again from the SERVED seed set (it
  cannot be built from the reference's own set where a near-tie went
  the other way): the structure must be equal, and each `mean(emb)`
  component is held by its absolute error against the float64 mean.

`answer` is the reference put in the program's place; with
`precision="tf32"` it is the control: the vectors rounded to TF32's
10-bit mantissa, scores and means computed in float32.
"""

from __future__ import annotations

import json

import numpy as np
import torch

FEAT_KEY = "mean(emb)"


def _csr(src: np.ndarray, dst: np.ndarray, n: int):
    """Deduplicated (indptr, indices), neighbours ascending."""
    key = np.unique(src.astype(np.int64) * n + dst.astype(np.int64))
    s, d = key // n, key % n
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=n), out=indptr[1:])
    return indptr, d


class Graph:
    """The generated graph as uid-indexed plain arrays."""

    def __init__(self, g, tag_names):
        self.n = int(g.n_nodes) + 1
        hc = g.has_creator
        self.creator = _csr(hc[:, 0], hc[:, 1], self.n)
        ro = g.reply_of
        self.reply_of = _csr(ro[:, 0], ro[:, 1], self.n)
        self.replies = _csr(ro[:, 1], ro[:, 0], self.n)
        ht = g.has_tag
        self.tags = _csr(ht[:, 0], ht[:, 1], self.n)
        self.first_name = {int(u): g.first_name[i]
                           for i, u in enumerate(g.person_uids.tolist())}
        self.tag_name = {int(u): tag_names[i]
                         for i, u in enumerate(g.tag_uids.tolist())}

    @staticmethod
    def nbrs(rel, u: int) -> list:
        indptr, indices = rel
        return indices[indptr[u]:indptr[u + 1]].tolist()


def _hex(u: int) -> str:
    return f"0x{u:x}"


def render(graph: Graph, template: str, roots: list, vecs,
           agg_dtype=np.float64) -> dict:
    """The answer of `template` below the sorted seed uids `roots`;
    `vecs` [rows, d] (numpy, row = uid - 1) feeds `@msgpass`."""
    objs = []
    if template == "knn_hop":
        for u in roots:
            o = {"uid": _hex(u)}
            kids = [{"uid": _hex(c), "first_name": graph.first_name[c]}
                    for c in graph.nbrs(graph.creator, u)]
            if kids:
                o["has_creator"] = kids
            objs.append(o)
    elif template == "knn_uid":
        for u in roots:
            o = {"uid": _hex(u)}
            kids = [{"tag_name": graph.tag_name[t]}
                    for t in graph.nbrs(graph.tags, u)]
            if kids:
                o["has_tag"] = kids
            objs.append(o)
    elif template == "knn_recurse":
        objs = _recurse(graph, roots, graph.reply_of, "reply_of", 3, None,
                        agg_dtype)
    elif template == "knn_featprop":
        objs = _recurse(graph, roots, graph.replies, "~reply_of", 2, vecs,
                        agg_dtype)
    else:
        raise ValueError(f"no reference for template {template!r}")
    return {"q": objs}


def _recurse(graph, roots, rel, key, depth, vecs, agg_dtype) -> list:
    """@recurse(depth, loop: false): each level expands its frontier's
    edges to nodes not seen before the level; a node is expanded once.
    With `vecs`, each expanded node with kept edges binds the mean of
    its kept children's rows."""
    seen = set(roots)
    frontier = sorted(roots)
    edges: dict = {}
    for _ in range(depth):
        nxt = set()
        for p in frontier:
            kids = [c for c in Graph.nbrs(rel, p) if c not in seen]
            if kids:
                edges[p] = kids
                nxt.update(kids)
        seen |= nxt
        frontier = sorted(nxt)

    memo: dict = {}

    def obj(u):
        if u in memo:
            return memo[u]
        o = {"uid": _hex(u)}
        kids = edges.get(u)
        if kids:
            if vecs is not None:
                rows = vecs[np.asarray(kids) - 1].astype(agg_dtype)
                s = rows[0].copy()
                for r in rows[1:]:
                    s += r
                o[FEAT_KEY] = (s / agg_dtype(len(kids))).tolist()
            o[key] = [obj(c) for c in kids]
        memo[u] = o
        return o

    return [obj(u) for u in sorted(roots)]


def compare(got, want) -> tuple[bool, float]:
    """(structure equal, widest absolute error of a `mean(emb)`
    component)."""
    err = 0.0

    def walk(a, b) -> bool:
        nonlocal err
        if isinstance(b, dict):
            if not isinstance(a, dict) or set(a) != set(b):
                return False
            for k in b:
                if k == FEAT_KEY:
                    x, y = np.asarray(a[k], np.float64), np.asarray(b[k],
                                                                    np.float64)
                    if x.shape != y.shape or not np.all(np.isfinite(x)):
                        return False
                    err = max(err, float(np.max(np.abs(x - y))))
                elif not walk(a[k], b[k]):
                    return False
            return True
        if isinstance(b, list):
            return (isinstance(a, list) and len(a) == len(b)
                    and all(walk(x, y) for x, y in zip(a, b)))
        return a == b

    ok = walk(got, want)
    return ok, err


def served_roots(obj) -> list | None:
    """The seed uids a served answer lists, or None if it has none."""
    try:
        return [int(o["uid"], 16) for o in obj["q"]]
    except (KeyError, TypeError, ValueError):
        return None


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _order_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys ascending in (score descending, row ascending), per
    column of a [rows, b] float32 score matrix."""
    neg = (-scores + 0.0).contiguous()
    bits = neg.view(torch.int32).to(torch.int64)
    okey = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rows = torch.arange(scores.shape[0], device=scores.device)
    return (okey << 32) | rows[:, None]


class Scanner:
    """Exact float64 scores of query vectors against the whole tablet
    (on the tablet's device, `block` queries per product)."""

    def __init__(self, vecs: torch.Tensor, block: int = 64):
        self.vecs = vecs
        self.block = block
        self.scale_row = float(torch.sqrt(
            (vecs.to(torch.float64) ** 2).sum(1).mean()))

    def gaps(self, queries: torch.Tensor, served: list, ks: list) -> list:
        """Per query: the widest relative gap of its served seeds below
        the exact k-th best score, or None when a served seed is not a
        tablet row, repeats, or the count is not k."""
        out = []
        rows = self.vecs.shape[0]
        v64 = self.vecs.to(torch.float64)
        for lo in range(0, len(served), self.block):
            q = queries[lo:lo + self.block].to(torch.float64)
            s = v64 @ q.T                               # [rows, b]
            for j in range(q.shape[0]):
                r, k = served[lo + j], ks[lo + j]
                if (r is None or len(r) != k or len(set(r)) != k
                        or min(r) < 1 or max(r) > rows):
                    out.append(None)
                    continue
                col = s[:, j]
                kth = torch.topk(col, k).values[-1]
                low = col[torch.as_tensor(r, device=col.device) - 1].min()
                scale = float(torch.linalg.vector_norm(q[j])) * self.scale_row
                out.append(max(0.0, float(kth - low)) / scale)
            del s
        del v64
        return out

    def control_topk(self, queries: torch.Tensor, ks: list) -> list:
        """The control's seed sets: TF32-rounded vectors, float32 scores,
        ties by the lower row; sorted uids."""
        v = tf32(self.vecs)
        out = []
        for lo in range(0, queries.shape[0], self.block):
            q = tf32(queries[lo:lo + self.block].to(torch.float32))
            keys = _order_keys(v @ q.T)
            for j in range(q.shape[0]):
                k = ks[lo + j]
                idx = torch.topk(keys[:, j], k, largest=False).indices
                out.append(sorted((idx + 1).tolist()))
        return out


def judge(graph: Graph, vecs_np: np.ndarray, scanner: Scanner,
          requests: list, bodies: list) -> dict:
    """Judge served answers. `requests`: dicts with `template`, `k` and
    the float32 query vector `q` (numpy); `bodies`: the response bytes.
    Returns the widest seed gap, the widest mean error, and the answers
    whose structure differs from the reference's."""
    objs, served = [], []
    for body in bodies:
        try:
            o = json.loads(body)
        except (TypeError, ValueError):
            o = None
        objs.append(o)
        served.append(served_roots(o) if o is not None else None)
    qs = torch.as_tensor(np.stack([r["q"] for r in requests]),
                         device=scanner.vecs.device)
    gaps = scanner.gaps(qs, served, [r["k"] for r in requests])
    widest_gap, widest_err, mismatched = 0.0, 0.0, 0
    for req, o, roots, gap in zip(requests, objs, served, gaps):
        if gap is None:
            mismatched += 1
            continue
        widest_gap = max(widest_gap, gap)
        ok, err = compare(o, render(graph, req["template"], sorted(roots),
                                    vecs_np))
        mismatched += 0 if ok else 1
        widest_err = max(widest_err, err)
    return {"knn_gap": widest_gap, "mean_err": widest_err,
            "mismatched": mismatched, "checked": len(requests)}


def control_bodies(graph: Graph, vecs: torch.Tensor, scanner: Scanner,
                   requests: list) -> list:
    """The control's answers to `requests`, as response bytes: seeds
    from TF32 float32 scores, means of TF32-rounded rows in float32."""
    qs = torch.as_tensor(np.stack([r["q"] for r in requests]),
                         device=vecs.device)
    seeds = scanner.control_topk(qs, [r["k"] for r in requests])
    v32 = tf32(vecs).cpu().numpy()
    return [json.dumps(render(graph, r["template"], s, v32,
                              agg_dtype=np.float32)).encode()
            for r, s in zip(requests, seeds)]
