"""JSON result assembly for batched `@recurse` results.

Port of `dgraph_tpu/engine/outputnode.py` for the paths the slice
renders: root blocks, scalar/uid/count leaves and `loop: false` recurse
rows, with the reference's JSON conventions ("0x%x" uids, RFC3339
datetimes, empty lists omitted). Aggregates, val()/math() leaves,
checkpwd, `@*` language maps, facets, nested level trees, @normalize,
@groupby and shortest paths are ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import numpy as np

from dgraph_tpu_torch.engine.execute import LevelNode
from dgraph_tpu_torch.store.types import Kind

_LATER = "ROADMAP Queue 1 item 4: engine/outputnode.py"


def to_json(ex, roots: list[LevelNode]) -> dict:
    r = _Renderer(ex)
    out: dict = {}
    for node in roots:
        if node.sg.is_internal:
            continue
        name = node.sg.alias or node.sg.attr or "q"
        if node.sg.shortest is not None:
            raise NotImplementedError(f"shortest-path rendering ({_LATER})")
        out[name] = r.render_block(node)
    return out


class _Renderer:
    def __init__(self, ex):
        self.ex = ex
        self.store = ex.store
        # per-(leaf, rank-domain) batched lookups: one vectorized fetch
        # per level/predicate instead of a size-1 searchsorted per node
        # (each entry pins its domain array so id() keys stay unique)
        self._leaf_vals: dict = {}
        self._uid_strs: dict = {}
        self._degrees: dict = {}
        self._is_list: dict = {}
        self._rec_maps: dict = {}
        self._rec_obj_memo: dict = {}

    def _rec_rows(self, parents: np.ndarray, children: np.ndarray,
                  rank: int) -> np.ndarray:
        """children of `rank` in a recurse edge matrix — grouped ONCE per
        matrix (stable order preserved)."""
        ent = self._rec_maps.get(id(parents))
        if ent is None:
            order = np.argsort(parents, kind="stable")
            sp = parents[order]
            uniq, starts = np.unique(sp, return_index=True)
            ends = np.append(starts[1:], len(sp))
            m = {int(u): children[order[s:e]]
                 for u, s, e in zip(uniq.tolist(), starts.tolist(),
                                    ends.tolist())}
            ent = (m, parents)
            self._rec_maps[id(parents)] = ent
        return ent[0].get(rank, _EMPTY_I32)

    # -- batched per-level lookups -----------------------------------------
    def _leaf_vals_for(self, leaf, rank: int, domain) -> list:
        if domain is None or not len(domain):
            return self.store.values_for(leaf.attr, rank, leaf.lang)
        key = (id(leaf), id(domain))
        ent = self._leaf_vals.get(key)
        if ent is None:
            vmap = self.store.values_for_many(leaf.attr, domain, leaf.lang)
            ent = (vmap, set(domain.tolist()), domain)
            self._leaf_vals[key] = ent
        vmap, dset, _pin = ent
        if rank in vmap:
            return vmap[rank]
        if rank in dset:
            return []
        return self.store.values_for(leaf.attr, rank, leaf.lang)

    def _uid_for(self, rank: int, domain) -> str:
        if domain is None or not len(domain):
            return _uid_str(self.store.uid_of(rank))
        key = id(domain)
        ent = self._uid_strs.get(key)
        if ent is None:
            uids = self.store.uid_of(domain)
            ent = ({int(r): f"0x{int(u):x}"
                    for r, u in zip(domain.tolist(), uids.tolist())},
                   domain)
            self._uid_strs[key] = ent
        s = ent[0].get(rank)
        return s if s is not None else _uid_str(self.store.uid_of(rank))

    def _count_for(self, leaf, rank: int, domain) -> int:
        rel = self.store.rel(leaf.attr, leaf.is_reverse)
        if domain is None or not len(domain):
            return int(rel.degree(np.array([rank]))[0])
        key = (id(leaf), id(domain))
        ent = self._degrees.get(key)
        if ent is None:
            ent = (dict(zip(domain.tolist(),
                            rel.degree(domain).tolist())), domain)
            self._degrees[key] = ent
        d = ent[0].get(rank)
        return int(d) if d is not None else \
            int(rel.degree(np.array([rank]))[0])

    # -- blocks -------------------------------------------------------------
    def render_block(self, node: LevelNode) -> list:
        sg = node.sg
        if sg.normalize or sg.groupby or sg.cascade:
            raise NotImplementedError(
                f"@normalize/@groupby/@cascade rendering ({_LATER})")
        objs = []
        display = node.display if node.display is not None else node.nodes
        for rank in display.tolist():
            obj = self.node_obj(node, int(rank))
            if obj:
                objs.append(obj)
        objs.extend(self.block_level_entries(node))
        return objs

    def block_level_entries(self, node: LevelNode) -> list:
        """count(uid) renders as a standalone list entry."""
        entries = []
        for leaf in node.leaf_sgs:
            if leaf.is_agg:
                raise NotImplementedError(f"aggregate rendering ({_LATER})")
            if leaf.is_count and leaf.is_uid_leaf:
                entries.append({leaf.alias or "count": int(len(node.nodes))})
        return entries

    # -- nodes --------------------------------------------------------------
    def node_obj(self, level: LevelNode, rank: int) -> dict:
        if level.children:
            raise NotImplementedError(f"nested level rendering ({_LATER})")
        obj: dict = {}
        domain = level.display if level.display is not None else level.nodes
        for leaf in level.leaf_sgs:
            self._render_leaf(leaf, rank, obj, domain)
        if level.recurse_data is not None:
            self._render_recurse_children(level.recurse_data, rank, obj)
        return obj

    def _render_leaf(self, leaf, rank: int, obj: dict, domain=None) -> None:
        if leaf.is_agg or (leaf.is_count and leaf.is_uid_leaf):
            return  # block-level entries
        if leaf.is_uid_leaf:
            obj[leaf.alias or "uid"] = self._uid_for(rank, domain)
            return
        if leaf.is_count:
            name = leaf.alias or f"count({'~' if leaf.is_reverse else ''}{leaf.attr})"
            obj[name] = self._count_for(leaf, rank, domain)
            return
        if (leaf.is_val_leaf or leaf.math_expr is not None
                or leaf.checkpwd_val is not None or leaf.lang == "*"
                or leaf.facet_keys is not None):
            raise NotImplementedError(
                f"val()/math()/checkpwd/@*/facet leaf rendering ({_LATER})")
        # plain value predicate — (is_list, is_password) resolve from the
        # schema ONCE per leaf, not per rendered node
        info = self._is_list.get(id(leaf))
        if info is None:
            ps = self.store.schema.peek(leaf.attr)
            info = self._is_list[id(leaf)] = (
                bool(ps and ps.is_list),
                bool(ps and ps.kind == Kind.PASSWORD))
        is_list, is_password = info
        if is_password:
            return  # password hashes never render (reference semantics)
        vs = self._leaf_vals_for(leaf, rank, domain)
        if not vs:
            return
        name = leaf.alias or (f"{leaf.attr}@{leaf.lang}" if leaf.lang else leaf.attr)
        if is_list or len(vs) > 1:
            obj[name] = [_json_val(v) for v in vs]
        else:
            obj[name] = _json_val(vs[0])

    # -- recurse ------------------------------------------------------------
    def _render_recurse_children(self, data, rank: int, obj: dict) -> None:
        if data.loop:
            raise NotImplementedError(
                f"@recurse(loop: true) rendering ({_LATER})")
        for leaf in data.leaf_sgs:
            self._render_leaf(leaf, rank, obj, domain=data.all_nodes)
        for i, esg in enumerate(data.edge_sgs):
            if i not in data.edges:
                continue
            parents, children = data.edges[i]
            rows = self._rec_rows(parents, children, rank)
            self._emit_recurse_rows(data, esg, rows, obj)

    def _emit_recurse_rows(self, data, esg, rows, obj: dict) -> None:
        if not len(rows):
            return
        name = esg.alias or (f"~{esg.attr}" if esg.is_reverse else esg.attr)
        # loop=false: a rank's subtree is depth-independent (its children
        # always come from the global first-visit matrix), so a node
        # reached by many parents renders once
        memo = self._rec_obj_memo.setdefault(id(data), {})
        lst = []
        for cr in rows.tolist():
            cr = int(cr)
            o = memo.get(cr)
            if o is None:
                o = {}
                self._render_recurse_children(data, cr, o)
                memo[cr] = o
            if o:
                lst.append(o)
        if lst:
            obj[name] = lst


# -- helpers ----------------------------------------------------------------

_EMPTY_I32 = np.zeros(0, np.int32)


def _uid_str(uid) -> str:
    return f"0x{int(uid):x}"


def _json_val(v):
    if isinstance(v, np.datetime64):
        s = np.datetime_as_string(v, unit="us")
        if s.endswith(".000000"):
            s = s[:-7]
        return s + "Z"
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    return str(v)
