"""JSON result assembly from executed LevelNode trees.

Port of `dgraph_tpu/engine/outputnode.py`: root blocks in their ordered
and paginated display order, nested levels (the matrices (seg, child)
ARE the tree; rows group per parent with one stable argsort per level),
scalar/uid/count/val() leaves, `@*` language maps, facets on edges and
value postings, `@recurse` rows (loop false and true) and shortest
paths, aggregates, math() and checkpwd leaves, @groupby, @normalize and
@cascade. JSON conventions match the reference:
  uids           "0x%x" strings
  datetimes      RFC3339 (UTC, "Z")
  geo values     GeoJSON objects
  vectors        float32vector values and @msgpass bindings as lists
  uid edges      lists of objects; empty lists omitted
  @normalize     flat objects, cartesian product across nested lists
  aggregates     separate objects appended to the block list
  shortest       "_path_" block of nested path objects
  @groupby       {"@groupby": [...]} wrapper objects
"""

from __future__ import annotations

import numpy as np

from dgraph_tpu_torch.engine.execute import LevelNode
from dgraph_tpu_torch.engine.groupby import _aggregate
from dgraph_tpu_torch.engine.mathexpr import eval_math
from dgraph_tpu_torch.store.geo import GeoVal
from dgraph_tpu_torch.store.types import Kind, check_password


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
        if node.groups is not None:
            return [{"@groupby": self._groups_list(node.groups)}]
        objs = []
        display = node.display if node.display is not None else node.nodes
        for rank in display.tolist():
            obj = self.node_obj(node, int(rank),
                                aliased_only=node.sg.normalize)
            if obj:
                objs.append(obj)
        objs.extend(self.block_level_entries(node))
        if node.sg.normalize:
            flat = []
            for o in objs:
                flat.extend(_normalize(o))
            return flat
        return objs

    def block_level_entries(self, node: LevelNode) -> list:
        """Aggregates and count(uid) render as standalone list entries."""
        entries = []
        for leaf in node.leaf_sgs:
            if leaf.is_agg:
                var = self.ex.val_vars.get(leaf.attr, {})
                if node.sg.func is None:
                    # func-less aggregation block (`s() { min(val(a)) }`):
                    # the domain is the var's whole binding
                    vals = list(var.values())
                else:
                    vals = [var[int(r)] for r in node.nodes.tolist()
                            if int(r) in var]
                self._agg_entry(leaf, vals, entries)
            elif leaf.is_count and leaf.is_uid_leaf:
                entries.append({leaf.alias or "count": int(len(node.nodes))})
        return entries

    def _agg_entry(self, leaf, vals: list, entries: list) -> None:
        v = _aggregate(leaf.agg_func, vals)
        if v is not None:  # min/max over no values: omitted
            name = leaf.alias or f"{leaf.agg_func}(val({leaf.attr}))"
            entries.append({name: _json_val(v)})

    # -- nodes --------------------------------------------------------------
    def node_obj(self, level: LevelNode, rank: int,
                 aliased_only: bool = False) -> dict | None:
        """One node's object, or None when @cascade drops it."""
        obj: dict = {}
        domain = level.display if level.display is not None else level.nodes
        for leaf in level.leaf_sgs:
            self._render_leaf(leaf, rank, obj, aliased_only, domain)
        if level.feat_vals is not None and rank in level.feat_vals:
            obj[level.feat_key] = _json_val(level.feat_vals[rank])
        if level.recurse_data is not None:
            self._render_recurse_children(level.recurse_data, rank, obj,
                                          depth=0)
        for child in level.children:
            self._render_edge(child, level, rank, obj, aliased_only)
        if level.sg.cascade and not _cascade_ok(level, obj):
            return None
        return obj

    def _render_leaf(self, leaf, rank: int, obj: dict,
                     aliased_only: bool = False, domain=None) -> None:
        if leaf.is_agg or (leaf.is_count and leaf.is_uid_leaf):
            return  # block-level entries
        if aliased_only and not leaf.alias and not leaf.is_uid_leaf:
            return  # @normalize: only aliased predicates survive
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
        if leaf.math_expr is not None:
            var = self.ex.val_vars.get(leaf.var_name or leaf.alias or "", {})
            if rank in var:
                if leaf.alias:
                    obj[leaf.alias] = _json_val(var[rank])
            elif leaf.alias:
                v = eval_math(leaf.math_expr, [rank], self.ex.val_vars)
                if rank in v:
                    obj[leaf.alias] = _json_val(v[rank])
            return
        if leaf.checkpwd_val is not None:
            # checkpwd(pred, "pw"): verify against the stored hash; the
            # hash itself never renders
            vs = self._leaf_vals_for(leaf, rank, domain)
            ok = any(check_password(leaf.checkpwd_val, str(v))
                     for v in vs)
            obj[leaf.alias or f"checkpwd({leaf.attr})"] = ok
            return
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
                     obj: dict, aliased_only: bool = False) -> None:
        name = child.sg.alias or (
            f"~{child.sg.attr}" if child.sg.is_reverse else child.sg.attr)
        if child.groups is not None:
            g = child.groups.get(int(np.searchsorted(parent.nodes, rank)))
            if g is not None and g.groups:
                obj[name] = [{"@groupby": self._groups_list(g)}]
            return
        rows, row_idx = self._rows(child, parent, rank)
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
        memo = self._obj_memo.setdefault((id(child), aliased_only), {})
        lst = []
        for j, cr in enumerate(rows.tolist()):
            cr = int(cr)
            o = memo.get(cr, _MISS)
            if o is _MISS:
                o = memo[cr] = self.node_obj(child, cr, aliased_only)
            if o is None:
                continue  # dropped by @cascade
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
        """Nested aggregates and count(uid): evaluated over THIS parent's
        row members."""
        entries = []
        for leaf in child.leaf_sgs:
            if leaf.is_agg:
                var = self.ex.val_vars.get(leaf.attr, {})
                vals = [var[r] for r in np.unique(rows).tolist() if r in var]
                self._agg_entry(leaf, vals, entries)
            elif leaf.is_count and leaf.is_uid_leaf:
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
        if data.feat_vals is not None and rank in data.feat_vals:
            obj[data.feat_key] = _json_val(data.feat_vals[rank])
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

    # -- groupby ------------------------------------------------------------
    def _groups_list(self, gr) -> list:
        out = []
        for key, aggs, _members in gr.groups:
            g = {a: _json_val(v) for a, v in key.items()}
            g.update({k: _json_val(v) for k, v in aggs.items()})
            out.append(g)
        return out

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
_MISS = object()  # memo sentinel (None is a real "cascade dropped" result)


def _uid_str(uid) -> str:
    return f"0x{int(uid):x}"


def _json_val(v):
    if isinstance(v, GeoVal):
        return v.obj  # geo scalars render as GeoJSON objects
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
    if isinstance(v, np.ndarray):  # float32vector: render as a list
        return [float(x) for x in v.tolist()]
    return str(v)


def _cascade_ok(level: LevelNode, obj: dict) -> bool:
    """@cascade: require the listed fields (or every queried field)."""
    fields = level.sg.cascade
    if fields and fields != ["__all__"]:
        required = fields
    else:
        required = []
        for leaf in level.leaf_sgs:
            if leaf.is_uid_leaf or leaf.is_agg:
                continue
            required.append(leaf.alias or (
                f"count({leaf.attr})" if leaf.is_count else
                (f"val({leaf.attr})" if leaf.is_val_leaf else
                 (f"{leaf.attr}@{leaf.lang}" if leaf.lang else leaf.attr))))
        for child in level.children:
            required.append(child.sg.alias or (
                f"~{child.sg.attr}" if child.sg.is_reverse else child.sg.attr))
    return all(f in obj for f in required)


def _normalize(obj: dict) -> list[dict]:
    """Cartesian flatten for @normalize (aliased scalars only survive —
    matching the reference's 'only aliased predicates are returned')."""
    base: dict = {}
    list_parts: list[list[dict]] = []
    for k, v in obj.items():
        if isinstance(v, list) and v and isinstance(v[0], dict):
            flats: list[dict] = []
            for o in v:
                flats.extend(_normalize(o))
            if flats:
                list_parts.append(flats)
        elif isinstance(v, dict):
            flats = _normalize(v)
            if flats:
                list_parts.append(flats)
        else:
            base[k] = v
    results = [base]
    for part in list_parts:
        results = [dict(r, **p) for r in results for p in part]
    return results
