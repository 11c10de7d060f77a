"""Native JSON emission: lower executed LevelNode trees to columnar specs.

Port of `dgraph_tpu/engine/emit.py`. A block whose features fit the
columnar form (plain value / uid / count / val leaves plus uid edges,
and loop=false `@recurse`) lowers to flat arrays: per-leaf pre-encoded
JSON fragments aligned to the level's rank domain, and per-child CSR
row maps in domain-position space. `native/emit.cpp` walks them, so no
per-object Python dict or list is built while serving. Other blocks
(@normalize, @cascade, @groupby, facets, aggregates, math, shortest
paths) render through the dict renderer, one block at a time.

A recurse block's depth assignment checkpoints the request's deadline
once per level ("emit"). `COUNTS` adds up, per process, the blocks
each route rendered ("native", "dict"), so a run can show that the
emitter served.
"""

from __future__ import annotations

import ctypes
import json
from json.encoder import encode_basestring_ascii as _esc

import numpy as np

from dgraph_tpu_torch import native
from dgraph_tpu_torch.engine.execute import LevelNode
from dgraph_tpu_torch.engine.outputnode import _json_val, _Renderer, to_json
from dgraph_tpu_torch.store.types import Kind
from dgraph_tpu_torch.utils import deadline

_SEP = (",", ":")

COUNTS = {"native": 0, "dict": 0}


def to_json_bytes(ex, roots: list[LevelNode]) -> bytes:
    """The serialized `to_json` result, native-emitted where eligible
    (equal JSON either way)."""
    if not native.HAVE_EMIT:
        return json.dumps(to_json(ex, roots), separators=_SEP).encode()
    r: _Renderer | None = None
    parts: dict[str, bytes] = {}
    path_objs: list | None = None
    for node in roots:
        if node.sg.is_internal:
            continue
        if node.sg.shortest is not None:
            if r is None:
                r = _Renderer(ex)
            if path_objs is None:
                path_objs = []
                parts["_path_"] = b"[]"  # pins insertion order
            path_objs.extend(r.render_paths(node))
            continue
        name = node.sg.alias or node.sg.attr or "q"
        payload = _emit_native(ex, node) if _eligible(node) else None
        if payload is None:
            if r is None:
                r = _Renderer(ex)
            payload = json.dumps(r.render_block(node),
                                 separators=_SEP).encode()
            COUNTS["dict"] += 1
        else:
            COUNTS["native"] += 1
        parts[name] = payload
    if path_objs is not None:
        parts["_path_"] = json.dumps(path_objs, separators=_SEP).encode()
    return b"{" + b",".join(
        _esc(k).encode() + b":" + v for k, v in parts.items()) + b"}"


def _eligible(node: LevelNode) -> bool:
    sg = node.sg
    if sg.msgpass is not None:
        # @msgpass bindings (vector-valued entries) stay on the dict
        # renderer: the native emitter has no float-list row kind
        return False
    if node.recurse_data is not None:
        return _recurse_eligible(node)
    if (node.groups is not None
            or node.path_data is not None or sg.normalize or sg.cascade
            or sg.facet_keys is not None):
        return False
    if not _leaves_eligible(node.leaf_sgs):
        return False
    return all(_eligible(child) for child in node.children)


def _leaves_eligible(leaf_sgs) -> bool:
    for leaf in leaf_sgs:
        if (leaf.is_agg or leaf.math_expr is not None
                or leaf.checkpwd_val is not None or leaf.lang == "*"
                or leaf.facet_keys is not None
                or (leaf.is_count and leaf.is_uid_leaf)):
            return False
    return True


def _recurse_eligible(node: LevelNode) -> bool:
    """loop=false @recurse lowers to a chain of per-depth levels (the
    first-visit forest is a level tree: ranks partition by first-visit
    depth, and the dict renderer draws each rank's subtree wherever it
    appears). loop=true and facet/paginated edges keep the dict
    renderer."""
    sg = node.sg
    data = node.recurse_data
    if (data.loop or sg.normalize or sg.cascade
            or sg.facet_keys is not None):
        return False
    for e in data.edge_sgs:
        if (e.facet_keys is not None or e.facet_orders
                or e.facet_filter is not None or e.orders
                or e.first or e.offset or e.after or e.children):
            return False
    return _leaves_eligible(data.leaf_sgs)


def _emit_native(ex, node: LevelNode) -> bytes | None:
    """One eligible root block → JSON array bytes (None: the lowering
    gave up and the dict renderer serves)."""
    keep: list = []     # pins every buffer the C side reads
    levels: list = []   # DgLevel structs in child-first order
    spec = _lower_level(ex, node, keep, levels)
    if spec is None:
        return None
    dom = node.nodes
    display = node.display if node.display is not None else dom
    pos = _positions(dom, np.asarray(display))
    if pos is None:
        return None
    return native.emit_block(spec, pos, len(levels))


def _positions(dom: np.ndarray, ranks: np.ndarray) -> np.ndarray | None:
    """Ranks → positions in the sorted domain; None if any rank is
    absent."""
    if not len(ranks):
        return np.zeros(0, np.int32)
    if not len(dom):
        return None
    pos = np.minimum(np.searchsorted(dom, ranks), len(dom) - 1)
    if not np.array_equal(dom[pos], ranks):
        return None
    return pos.astype(np.int32)


def _edges_for(ps: np.ndarray, cs: np.ndarray, dom: np.ndarray):
    """Edges whose (parent-sorted) parents fall in sorted `dom` →
    (row counts per dom position, child ranks grouped by dom position,
    stored order kept within each parent)."""
    lo = np.searchsorted(ps, dom, "left")
    hi = np.searchsorted(ps, dom, "right")
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    if not total:
        return counts, np.zeros(0, cs.dtype)
    base = np.repeat(np.cumsum(counts) - counts, counts)
    rows = np.repeat(lo.astype(np.int64), counts) + np.arange(total) - base
    return counts, cs[rows]


def _lower_recurse(ex, node: LevelNode, keep: list, levels: list):
    """loop=false RecurseData → chained DgLevels, one per first-visit
    depth. A rank's children in the global first-visit matrix link only
    to next-depth ranks, so the chain reproduces the dict renderer's
    memoized subtrees exactly. Each predicate's edge matrix is sorted by
    parent once; each level selects its slice by searchsorted ranges."""
    data = node.recurse_data
    grouped = {}
    for i in data.edges:
        parents, childs = data.edges[i]
        order = np.argsort(parents, kind="stable")  # keeps stored order
        grouped[i] = (parents[order], childs[order])

    # depth assignment: roots at 0; a fresh child's depth = parent + 1
    seen: set[int] = {int(r) for r in node.nodes}
    level_doms = [np.asarray(node.nodes, np.int32)]
    while True:
        deadline.checkpoint("emit")
        parts = [_edges_for(ps, cs, level_doms[-1])[1]
                 for ps, cs in grouped.values()]
        parts = [p for p in parts if len(p)]
        if not parts:
            break
        nxt = np.unique(np.concatenate(parts))
        nxt = np.array([c for c in nxt.tolist() if c not in seen],
                       np.int32)
        if not len(nxt):
            break
        seen.update(nxt.tolist())
        level_doms.append(nxt)

    # build bottom-up so each level can point at the next
    next_lvl = None
    for h in range(len(level_doms) - 1, -1, -1):
        dom = level_doms[h]
        leaves = []
        for leaf in data.leaf_sgs:
            lowered = _lower_leaf(ex, leaf, dom, keep)
            if lowered is not None:
                leaves.append(lowered)
        children = []
        if next_lvl is not None:
            ndom = level_doms[h + 1]
            for i, esg in enumerate(data.edge_sgs):
                if i not in grouped:
                    continue
                counts, c_h = _edges_for(*grouped[i], dom)
                if not len(c_h):
                    continue
                indptr = np.concatenate(
                    [[0], np.cumsum(counts)]).astype(np.int64)
                pos = _positions(ndom, c_h)
                if pos is None:
                    return None
                name = esg.alias or (
                    f"~{esg.attr}" if esg.is_reverse else esg.attr)
                key = _key(name, keep)
                keep += [pos, indptr]
                children.append(native.DgChild(
                    key=_bp(key), key_len=len(key),
                    level=ctypes.pointer(next_lvl),
                    row_indptr=_vp(indptr), row_child=_vp(pos)))
        next_lvl = _build_level(len(dom), leaves, children, keep, levels)
    return next_lvl


def _build_level(dom_len: int, leaves: list, children: list, keep: list,
                 levels: list):
    """Assemble one DgLevel from lowered leaves and children (the one
    ctypes layout site of the plain and recurse lowerings)."""
    leaf_arr = (native.DgLeaf * len(leaves))(*leaves) if leaves else None
    child_arr = (native.DgChild * len(children))(*children) if children \
        else None
    keep += [leaf_arr, child_arr]
    lvl = native.DgLevel(
        n=dom_len,
        n_leaves=len(leaves),
        leaves=ctypes.cast(leaf_arr, ctypes.POINTER(native.DgLeaf))
        if leaf_arr else None,
        n_children=len(children),
        children=ctypes.cast(child_arr, ctypes.POINTER(native.DgChild))
        if child_arr else None,
        level_id=len(levels))
    levels.append(lvl)
    return lvl


def _lower_level(ex, node: LevelNode, keep: list, levels: list):
    if node.recurse_data is not None:
        return _lower_recurse(ex, node, keep, levels)
    dom = node.nodes
    leaves = []
    for leaf in node.leaf_sgs:
        lowered = _lower_leaf(ex, leaf, dom, keep)
        if lowered is not None:
            leaves.append(lowered)
    children = []
    for child in node.children:
        clevel = _lower_level(ex, child, keep, levels)
        if clevel is None:
            return None
        row_child, indptr = _row_map(child, len(dom))
        if row_child is None:
            return None
        name = child.sg.alias or (
            f"~{child.sg.attr}" if child.sg.is_reverse else child.sg.attr)
        key = _key(name, keep)
        keep += [row_child, indptr]
        children.append(native.DgChild(
            key=_bp(key), key_len=len(key), level=ctypes.pointer(clevel),
            row_indptr=_vp(indptr), row_child=_vp(row_child)))
    return _build_level(len(dom), leaves, children, keep, levels)


def _row_map(child: LevelNode, n_parent: int):
    """(row_child positions, row_indptr): the child's matrix grouped by
    parent position, matrix order kept (the dict renderer's grouping)."""
    seg = np.asarray(child.matrix_seg)
    order = np.argsort(seg, kind="stable")
    indptr = np.searchsorted(seg[order],
                             np.arange(n_parent + 1)).astype(np.int64)
    ranks = np.asarray(child.matrix_child)[order]
    pos = _positions(child.nodes, ranks)
    return pos, indptr


def _lower_leaf(ex, leaf, dom: np.ndarray, keep: list):
    """One leaf SubGraph → DgLeaf column; None when the leaf renders
    nothing (password predicates)."""
    store = ex.store
    n = len(dom)
    if leaf.is_uid_leaf:
        key = _key(leaf.alias or "uid", keep)
        uids = np.ascontiguousarray(
            store.uid_of(dom) if n else np.zeros(0), np.int64)
        keep.append(uids)
        return native.DgLeaf(key=_bp(key), key_len=len(key), kind=1,
                             nums=_vp(uids))
    if leaf.is_count:
        rel = store.rel(leaf.attr, leaf.is_reverse)
        counts = np.ascontiguousarray(
            rel.degree(dom) if n else np.zeros(0), np.int64)
        keep.append(counts)
        name = leaf.alias or \
            f"count({'~' if leaf.is_reverse else ''}{leaf.attr})"
        key = _key(name, keep)
        return native.DgLeaf(key=_bp(key), key_len=len(key), kind=2,
                             nums=_vp(counts))
    if leaf.is_val_leaf:
        var = ex.val_vars.get(leaf.attr, {})
        frags = ["" if int(rk) not in var else _enc(_json_val(var[int(rk)]))
                 for rk in dom.tolist()]
        return _frag_leaf(leaf.alias or f"val({leaf.attr})", frags, keep)
    # plain value predicate
    ps = store.schema.peek(leaf.attr)
    if ps and ps.kind == Kind.PASSWORD:
        return None  # hashes never render
    is_list = bool(ps and ps.is_list)
    name0 = leaf.alias or (
        f"{leaf.attr}@{leaf.lang}" if leaf.lang else leaf.attr)
    if not leaf.lang and not is_list:
        fast = _int_col_frags(store, leaf.attr, dom)
        if fast is not None:
            return _frag_leaf(name0, fast, keep)
    vmap = store.values_for_many(leaf.attr, dom, leaf.lang)
    frags = [""] * n
    for i, rk in enumerate(dom.tolist()):
        vs = vmap.get(rk)
        if not vs:
            continue
        if is_list or len(vs) > 1:
            frags[i] = "[" + ",".join(_enc(_json_val(v)) for v in vs) + "]"
        else:
            frags[i] = _enc(_json_val(vs[0]))
    return _frag_leaf(name0, frags, keep)


def _int_col_frags(store, attr: str, dom: np.ndarray):
    """Vectorized fragments of a single-valued untagged int column
    (creation_ts, birthday_year: the hot render leaves of the LDBC mix):
    one searchsorted pair and one numpy int→str conversion. None when
    the column needs the generic path."""
    pd = store.preds.get(attr)
    if pd is None:
        return [""] * len(dom)
    if list(pd.vals) != [""]:
        return None
    col = pd.vals[""]
    if col.vals.dtype.kind != "i":
        return None
    if not len(dom):
        return []
    lo = np.searchsorted(col.subj, dom, "left")
    hi = np.searchsorted(col.subj, dom, "right")
    if len(col.subj) and int((hi - lo).max()) > 1:
        return None  # multi-valued rows despite a non-list schema
    hit = hi > lo
    frags = [""] * len(dom)
    if hit.any():
        strs = col.vals[lo[hit]].astype(np.str_).tolist()
        for i, s in zip(np.nonzero(hit)[0].tolist(), strs):
            frags[i] = s
    return frags


def _frag_leaf(name: str, frags: list[str], keep: list):
    blob = "".join(frags).encode("ascii")
    off = np.zeros(len(frags) + 1, np.int64)
    if frags:
        np.cumsum(np.fromiter((len(f) for f in frags), np.int64,
                              len(frags)), out=off[1:])
    key = _key(name, keep)
    keep += [blob, off]
    return native.DgLeaf(key=_bp(key), key_len=len(key), kind=0,
                         frag_off=_vp(off), frag_blob=_bp(blob))


def _enc(v) -> str:
    """One post-_json_val scalar → its JSON fragment (always ASCII)."""
    t = type(v)
    if t is str:
        return _esc(v)
    if t is bool:
        return "true" if v else "false"
    if t is int:
        return repr(v)
    return json.dumps(v, separators=_SEP)


def _key(name: str, keep: list) -> bytes:
    key = (_esc(name) + ":").encode("ascii")
    keep.append(key)
    return key


def _vp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bp(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
