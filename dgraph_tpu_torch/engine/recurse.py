"""@recurse result data and variable binding.

Port of `dgraph_tpu/engine/recurse.py`'s `RecurseData` and
`_bind_recurse_vars`: what the batched lane kernel's rebuild fills in
and the renderer walks. The per-query host loop (`expand_recurse`) and
the mesh routes are ROADMAP Queue 1 items 3-4 and 10.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dgraph_tpu_torch.engine.ir import SubGraph


@dataclass
class RecurseData:
    """Per-predicate edge lists accumulated over all depths.

    `edges[pred_key]` = (parents, children) rank arrays; every parent rank
    appears in at most one depth (loop=false), so rows are unambiguous.
    """

    edge_sgs: list[SubGraph] = field(default_factory=list)
    leaf_sgs: list[SubGraph] = field(default_factory=list)
    # loop=false: one global matrix per predicate
    edges: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    loop: bool = False
    all_nodes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))


def _bind_recurse_vars(ex, root, data: RecurseData, sg: SubGraph) -> None:
    """Leaf value vars bind over every visited node; the block's uid var
    is the whole reachable set."""
    for leaf in data.leaf_sgs:
        if leaf.var_name:
            saved_nodes = root.nodes
            root.nodes = data.all_nodes
            ex._record_leaf_vars(leaf, root)
            root.nodes = saved_nodes
    if sg.var_name:
        ex.uid_vars[sg.var_name] = data.all_nodes
