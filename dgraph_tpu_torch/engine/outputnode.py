"""JSON result assembly from executed LevelNode trees.

Port of `dgraph_tpu/engine/outputnode.py`: root blocks in their ordered
and paginated display order, nested levels (the matrices (seg, child)
ARE the tree; rows group per parent with one stable argsort per level),
scalar/uid/count/val() leaves, `@*` language maps, facets on edges and
value postings, `@recurse` rows (loop false and true) and shortest
paths. JSON conventions match the reference: "0x%x" uids, RFC3339
datetimes, empty lists omitted, count(uid) as a standalone entry.
Aggregates, math() leaves, checkpwd, @normalize, @groupby and @cascade
raise until they are ported (ROADMAP Queue 1 item 4).
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
            out.setdefault("_path_", []).extend(r.render_paths(node))
            continue
        out[name] = r.render_block(node)
    return out


class _Renderer:
    def __init__(self, ex):
        self.ex = ex
        self.store = ex.store
        self._row_maps: dict[int, dict[int, tuple]] = {}
        # per-(leaf, rank-domain) batched lookups: one vectorized fetch
        # per level/predicate instead of a size-1 searchsorted per node
        # (each entry pins its domain array so id() keys stay unique)
        self._leaf_vals: dict = {}
        self._uid_strs: dict = {}
        self._degrees: dict = {}
        self._is_list: dict = {}
        self._obj_memo: dict = {}
        self._rec_maps: dict = {}
        self._rec_obj_memo: dict = {}
        self._facet_keys: dict = {}
        self._star_langs: dict = {}

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

    def _leaf_info(self, leaf) -> tuple[bool, bool]:
        """(is_list, is_password) from the schema, once per leaf."""
        info = self._is_list.get(id(leaf))
        if info is None:
            ps = self.store.schema.peek(leaf.attr)
            info = self._is_list[id(leaf)] = (
                bool(ps and ps.is_list),
                bool(ps and ps.kind == Kind.PASSWORD))
        return info

    # -- blocks -------------------------------------------------------------
    def render_block(self, node: LevelNode) -> list:
        if node.sg.normalize:
            raise NotImplementedError(f"@normalize rendering ({_LATER})")
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
        if level.sg.cascade:
            raise NotImplementedError(f"@cascade rendering ({_LATER})")
        obj: dict = {}
        domain = level.display if level.display is not None else level.nodes
        for leaf in level.leaf_sgs:
            self._render_leaf(leaf, rank, obj, domain)
        if level.recurse_data is not None:
            self._render_recurse_children(level.recurse_data, rank, obj,
                                          depth=0)
        for child in level.children:
            self._render_edge(child, level, rank, obj)
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
        if leaf.is_val_leaf:
            var = self.ex.val_vars.get(leaf.attr, {})
            if rank in var:
                obj[leaf.alias or f"val({leaf.attr})"] = _json_val(var[rank])
            return
        if leaf.math_expr is not None or leaf.checkpwd_val is not None:
            raise NotImplementedError(
                f"math()/checkpwd leaf rendering ({_LATER})")
        if leaf.lang == "*":
            # name@*: every language version, keyed per tag (untagged
            # renders under the bare name); passwords never render
            is_list, is_password = self._leaf_info(leaf)
            if is_password:
                return
            pd = self.store.preds.get(leaf.attr)
            langs = self._star_langs.get(id(leaf))
            if langs is None:
                langs = self._star_langs[id(leaf)] = (
                    sorted(pd.vals) if pd else ())
            base = leaf.alias or leaf.attr
            for lang in langs:
                vs = pd.vals[lang].get(rank)
                if not vs:
                    continue
                key = base if not lang else f"{base}@{lang}"
                obj[key] = (_json_val(vs[0])
                            if len(vs) == 1 and not is_list
                            else [_json_val(v) for v in vs])
            return
        # plain value predicate
        is_list, is_password = self._leaf_info(leaf)
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
        if leaf.facet_keys is not None:
            # facets on VALUE postings render as "name|key" siblings
            fk = self._facet_keys.get(id(leaf))
            if fk is None:
                fk = self._facet_keys[id(leaf)] = (
                    [k for _, k in leaf.facet_keys] or None,
                    {k: a for a, k in leaf.facet_keys if a})
            keys, aliases = fk
            for k, v in self.store.value_facets(leaf.attr, rank,
                                                keys).items():
                obj[aliases.get(k) or f"{name}|{k}"] = _json_val(v)

    def _render_edge(self, child: LevelNode, parent: LevelNode, rank: int,
                     obj: dict) -> None:
        rows, row_idx = self._rows(child, parent, rank)
        name = child.sg.alias or (
            f"~{child.sg.attr}" if child.sg.is_reverse else child.sg.attr)
        facet_cols = None
        if child.sg.facet_keys is not None and len(child.matrix_pos):
            keys = [k for _, k in child.sg.facet_keys] or None
            aliases = {k: a for a, k in (child.sg.facet_keys or []) if a}
            facet_cols = (self.store.edge_facets(
                child.sg.attr,
                self.ex.facet_positions(child.sg, child.matrix_pos),
                keys), aliases)
        # memoize per (level, rank): a popular child appears in MANY
        # parents' rows; its subtree renders once
        memo = self._obj_memo.setdefault(id(child), {})
        lst = []
        for j, cr in enumerate(rows.tolist()):
            cr = int(cr)
            o = memo.get(cr)
            if o is None:
                o = memo[cr] = self.node_obj(child, cr)
            if facet_cols is not None:
                cols, aliases = facet_cols
                o = dict(o)  # copy: facet annotations are per-row
                mi = int(row_idx[j])  # position into matrix arrays
                for k, vals in cols.items():
                    if vals[mi] is not None:
                        fname = aliases.get(k) or f"{name}|{k}"
                        o[fname] = _json_val(vals[mi])
            if o:
                lst.append(o)
        lst.extend(self._row_level_entries(child, rows))
        if lst:
            obj[name] = lst

    def _row_level_entries(self, child: LevelNode, rows: np.ndarray) -> list:
        """Nested count(uid): evaluated over THIS parent's row members."""
        entries = []
        for leaf in child.leaf_sgs:
            if leaf.is_agg:
                raise NotImplementedError(f"aggregate rendering ({_LATER})")
            if leaf.is_count and leaf.is_uid_leaf:
                entries.append({leaf.alias or "count": int(len(np.unique(rows)))})
        return entries

    _EMPTY_ROW = (np.zeros(0, np.int32), np.zeros(0, np.int64))

    def _rows(self, child: LevelNode, parent: LevelNode, rank: int):
        """Matrix row of `rank`: (child ranks in row order, their indices
        into the matrix arrays — matrix_pos/facet columns align to these).
        The map is keyed by parent RANK."""
        m = self._row_maps.get(id(child))
        if m is None:
            m = {}
            seg = child.matrix_seg
            order = np.argsort(seg, kind="stable")
            sseg = seg[order]
            starts = np.searchsorted(sseg, np.arange(len(parent.nodes)))
            ends = np.searchsorted(sseg, np.arange(len(parent.nodes)), "right")
            pranks = parent.nodes.tolist()
            for pos in range(len(parent.nodes)):
                if ends[pos] > starts[pos]:
                    idx = order[starts[pos]:ends[pos]]
                    m[int(pranks[pos])] = (child.matrix_child[idx], idx)
            self._row_maps[id(child)] = m
        return m.get(rank, self._EMPTY_ROW)

    # -- recurse ------------------------------------------------------------
    def _render_recurse_children(self, data, rank: int, obj: dict,
                                 depth: int) -> None:
        for leaf in data.leaf_sgs:
            self._render_leaf(leaf, rank, obj, domain=data.all_nodes)
        if data.loop:
            if depth >= len(data.by_depth):
                return
            level = data.by_depth[depth]
        else:
            level = data.edges
        for i, esg in enumerate(data.edge_sgs):
            if i not in level:
                continue
            parents, children = level[i]
            rows = self._rec_rows(parents, children, rank)
            self._emit_recurse_rows(data, esg, rows, obj, depth + 1)

    def _emit_recurse_rows(self, data, esg, rows, obj: dict, depth: int) -> None:
        if not len(rows):
            return
        name = esg.alias or (f"~{esg.attr}" if esg.is_reverse else esg.attr)
        # loop=false: a rank's subtree is depth-independent (its children
        # always come from the global first-visit matrix), so a node
        # reached by many parents renders once
        memo = (self._rec_obj_memo.setdefault(id(data), {})
                if not data.loop else None)
        lst = []
        for cr in rows.tolist():
            cr = int(cr)
            o = memo.get(cr) if memo is not None else None
            if o is None:
                o = {}
                self._render_recurse_children(data, cr, o, depth)
                if memo is not None:
                    memo[cr] = o
            if o:
                lst.append(o)
        if lst:
            obj[name] = lst

    # -- shortest -----------------------------------------------------------
    def render_paths(self, node: LevelNode) -> list:
        data = node.path_data
        if data is None or not data.paths:
            return []
        out = []
        for pi_, path in enumerate(data.paths):
            cur: dict | None = None
            for rank, pred_i in reversed(path):
                o = {"uid": _uid_str(self.store.uid_of(rank))}
                if cur is not None:
                    esg = data.edge_sgs[next_pred_i]
                    name = esg.alias or (
                        f"~{esg.attr}" if esg.is_reverse else esg.attr)
                    o[name] = cur
                cur = o
                next_pred_i = pred_i
            if data.weights:
                cur["_weight_"] = data.weights[pi_]
            out.append(cur)
        return out


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
