"""Batched traversal over lane-packed frontier bitmaps — the throughput path.

Port of the ELL half of `dgraph_tpu/ops/bfs.py`. B concurrent
depth-bounded `@recurse` queries ride the bit-lanes of one mask
[n+1, W] (B = 32·W; row n is an all-zero sentinel), and one hop for all
of them is a pull over in-neighbour lists: next[v] = OR of frontier[u]
over in-neighbours u.

The host layout (`EllGraph`, `build_ell`, `pack_seed_masks`,
`unpack_masks`) stays numpy and produces arrays equal to the
reference's. On the device:

  * lane words are torch.int32 holding the reference's uint32 bits
    (compare with `.view(np.uint32)`);
  * every bucket of a hop — the dense degree classes, the heavy tail's
    tile partials and its second-level combines — is one entry of the
    graph's launch table (`prepare_parts`, `hop_table`), writing straight
    into its row slice of the next mask with its row-occupancy flags;
    each of the table's two levels is one launch of the CUDA bucket-hop
    kernel (`ops/bucket_hop.py`), so a hop is two launches;
  * the depth scan is a Python loop over hops whose launches also run
    the first-visit update (fresh = next & ~seen; seen |= fresh) and
    skip the frontier rows flagged empty;
  * the per-lane edge counter is exact: blocked float64 products, exact
    for any total below 2^53 (the reference's f32 matvec is exact only
    below 2^24 per lane).

Two more programs ride the same hop: `make_ell_step`, a resumable block
of hops whose carries the caller hands forward (the shortest-path lane
groups), and `make_ell_tree`, the level-tree pipeline over masks in the
store's global rank space (the level-tree lane groups). Their row
gathers and ANDs are torch ops; every gather-OR is the bucket hop.

The reference's push-form COO hop over `[n, B]` int8 masks (one lane
per byte) is here too, as torch ops: `bitmap_hop` gathers the frontier
rows of every edge's `src` and scatter-maxes them into `dst`
(`scatter_max_rows`; out-of-range `dst` slots drop), and
`bitmap_recurse` is its depth-bounded loop=false `@recurse`, with
`ranks_to_bitmap` / `bitmap_to_ranks` the host helpers. Its per-lane
edge counter is exact (float64 block products), where the reference's
f32 matvec is exact below 2^24 per lane. The mesh's slab-sharded form
is `parallel/dbfs.py`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from dgraph_tpu_torch.ops.bucket_hop import (OUT, PARTIALS, HopTable,
                                              bucket_hop, build_table,
                                              run_table, table_key,
                                              walk_table)
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["ranks_to_bitmap", "bitmap_to_ranks", "bitmap_hop",
           "bitmap_recurse", "lane_edges", "scatter_max_rows", "EllGraph",
           "build_ell", "pack_seed_masks", "unpack_masks",
           "put_mask", "DeviceEll", "device_ell", "prepare_parts", "hop_table",
           "make_ell_count", "make_ell_recurse", "make_ell_step",
           "make_ell_tree"]

def scatter_max_rows(out: torch.Tensor, index: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """`out[index[i]] = max(out[index[i]], rows[i])` for every i, in
    place (`index_reduce_`, which torch marks beta: its warning is
    silenced here)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"index_reduce\(\)")
        return out.index_reduce_(0, index, rows, "amax")


def ranks_to_bitmap(rank_lists, n_nodes: int) -> np.ndarray:
    """Host helper: B rank lists → [n_nodes, B] int8 frontier bitmap."""
    out = np.zeros((n_nodes, len(rank_lists)), np.int8)
    for q, ranks in enumerate(rank_lists):
        out[np.asarray(ranks, np.int64), q] = 1
    return out


def bitmap_to_ranks(mask) -> list:
    """Host helper: [n_nodes, B] bitmap → list of B sorted rank arrays."""
    m = np.asarray(mask)
    return [np.nonzero(m[:, q])[0].astype(np.int32)
            for q in range(m.shape[1])]


def _on(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def bitmap_hop(src, dst, mask: torch.Tensor) -> torch.Tensor:
    """One hop of B concurrent traversals over a COO edge list:
    next[v, q] = OR over edges u→v of mask[u, q]. `src`/`dst` [E] int32
    (any order) on the mask's device; `src` clamps into the rows, a
    `dst` outside them is dropped."""
    n = mask.shape[0]
    src = _on(src, mask.device).long().clamp(0, max(n - 1, 0))
    dst = _on(dst, mask.device).long()
    dst = torch.where((dst >= 0) & (dst < n), dst, n)
    out = torch.zeros((n + 1, mask.shape[1]), dtype=mask.dtype,
                      device=mask.device)
    scatter_max_rows(out, dst, mask[src])
    return out[:n]


def lane_edges(deg: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-lane out-degree mass Σ_v deg[v]·mask[v, q], exact (float64
    products of COUNT_BLK-row blocks), int32 as the reference's."""
    acc = torch.zeros(mask.shape[1], dtype=torch.float64, device=mask.device)
    degf = deg.to(torch.float64)
    for lo in range(0, mask.shape[0], COUNT_BLK):
        hi = min(mask.shape[0], lo + COUNT_BLK)
        acc += degf[lo:hi] @ mask[lo:hi].to(torch.float64)
    return acc.round().to(torch.int32)


def bitmap_recurse(src, dst, deg, mask0, depth: int,
                   device=DEFAULT_DEVICE):
    """Depth-bounded loop=false @recurse for B queries at once over a COO
    edge list. `deg` [n] int32 is the out-degree (for edge counting),
    `mask0` [n, B] int8 each query's seed set; host arrays go to
    `device`, tensors stay where they are. Returns `(last[n, B],
    seen[n, B], edges[B] int32)`: each query's last fresh frontier, its
    visited set, and the edges traversed from every expanded frontier."""
    dev = (mask0.device if isinstance(mask0, torch.Tensor)
           else resolve_device(device))
    mask0 = _on(mask0, dev)
    src, dst, deg = _on(src, dev), _on(dst, dev), _on(deg, dev)
    frontier, seen = mask0, mask0
    edges = torch.zeros(mask0.shape[1], dtype=torch.int32, device=dev)
    for _h in range(depth):
        edges = edges + lane_edges(deg, frontier)
        nxt = bitmap_hop(src, dst, frontier)
        fresh = torch.where(seen > 0, 0, nxt).to(mask0.dtype)
        seen = torch.maximum(seen, fresh)
        frontier = fresh
    return frontier, seen, edges


SEG_MIN_DEG = 32      # dense-lane ELL up to this in-degree; heavier → tiles
SEG_TILE = 8          # segment-CSR tile width (max padding per heavy row)


@dataclass
class EllGraph:
    """Degree-bucketed in-neighbor blocks over a permuted rank space.

    `parts` lists the dense-lane blocks in permuted row order:
    ("zero", None, rows) for the indeg-0 class, ("ell", [rows, K] int32,
    rows) per present degree K ≤ seg_min. `tiles`/`lvl2` hold the heavy
    tail's segment-CSR (tile matrix + per-tile-count combine indices);
    heavy rows sit after all dense rows in the permutation."""

    n: int                                  # node count
    parts: list                             # dense blocks, permuted order
    tiles: object                           # [M, seg_tile] int32 | None
    lvl2: list                              # [h_b, K2] int32 tile combines
    seg_rows: int                           # heavy (tail) row count
    outdeg: object                          # [n] f32, permuted space
    perm_order: object                      # new rank -> old rank
    new_of_old: object                      # old rank -> new rank
    ks: list = field(default_factory=list)  # dense widths present

    @property
    def nnz(self) -> int:
        return int(self.outdeg.sum())

    @property
    def padded_edges(self) -> int:
        """Total level-1 gather slots (real edges + padding) — the device
        edge traffic per hop."""
        dense = sum(int(e.size) for kind, e, _ in self.parts
                    if kind == "ell")
        return dense + (int(self.tiles.size) if self.tiles is not None
                        else 0)


def build_ell(indptr, indices, seg_min: int = SEG_MIN_DEG,
              seg_tile: int = SEG_TILE) -> EllGraph:
    """Build the bucketed ELL + segment-CSR blocks from a CSR relation
    (host numpy, whole-graph vectorized passes; equal to the
    reference's arrays)."""
    n = indptr.shape[0] - 1
    deg_out = np.diff(indptr).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int32), deg_out)
    # CSR transpose: in-neighbors grouped by destination, sources
    # ascending within each group (stable sort keeps src order)
    order = np.argsort(indices, kind="stable")
    csrc = src[order]
    indeg = (np.bincount(indices, minlength=n).astype(np.int64) if n
             else np.zeros(0, np.int64))
    cindptr = np.concatenate([[0], np.cumsum(indeg)])

    small = indeg <= seg_min
    ks = sorted(int(k) for k in np.unique(indeg[small])) if n else [0]
    bucket = np.full(n, len(ks), np.int64)
    bucket[small] = np.searchsorted(np.array(ks), indeg[small])
    heavy = ~small
    ntiles = np.zeros(n, np.int64)
    ntiles[heavy] = -(-indeg[heavy] // seg_tile)
    # permutation: dense degree classes ascending, then the heavy tail by
    # tile count; first-neighbor secondary order gives consecutive rows
    # nearby gather targets
    first_nbr = np.full(n, n, np.int64)
    nz = indeg > 0
    first_nbr[nz] = csrc[cindptr[:-1][nz]]
    sort_key = np.where(heavy, len(ks) + ntiles, bucket)
    perm_order = np.lexsort((first_nbr, sort_key))
    new_of_old = np.empty(n, np.int64)
    new_of_old[perm_order] = np.arange(n)
    cnew = new_of_old[csrc] if len(csrc) else csrc.astype(np.int64)

    def fill_rows(nodes, K):
        """[len(nodes), K] in-neighbor block (pad=n), one vector pass."""
        nb = np.full((len(nodes), K), n, np.int32)
        deg = indeg[nodes]
        total = int(deg.sum())
        if total:
            cum = np.cumsum(deg)
            base = np.repeat(cum - deg, deg)
            ar = np.arange(total)
            flat = np.repeat(cindptr[nodes], deg) + ar - base
            nb[np.repeat(np.arange(len(nodes)), deg), ar - base] = \
                cnew[flat]
        return nb

    counts = np.bincount(bucket, minlength=len(ks) + 1)
    parts = []
    off = 0
    for i, K in enumerate(ks):
        nodes = perm_order[off:off + counts[i]]
        off += counts[i]
        if K == 0:
            parts.append(("zero", None, len(nodes)))
        else:
            parts.append(("ell", fill_rows(nodes, K), len(nodes)))
    heavy_nodes = perm_order[off:]
    seg_rows = len(heavy_nodes)
    tiles = None
    lvl2 = []
    if seg_rows:
        hdeg = indeg[heavy_nodes]
        hnt = -(-hdeg // seg_tile)
        M = int(hnt.sum())
        tiles = np.full((M, seg_tile), n, np.int32)
        total = int(hdeg.sum())
        cum = np.cumsum(hdeg)
        base = np.repeat(cum - hdeg, hdeg)
        ar = np.arange(total)
        within = ar - base
        tile_start = np.concatenate([[0], np.cumsum(hnt)])[:-1]
        flat = np.repeat(cindptr[heavy_nodes], hdeg) + within
        slot = np.repeat(tile_start * seg_tile, hdeg) + within
        tiles[slot // seg_tile, slot % seg_tile] = cnew[flat]
        # second level: combine each heavy row's tile partials; rows are
        # already ntile-sorted, so power-of-two buckets are contiguous
        k2s = sorted(set(int(1 << max(int(t - 1).bit_length(), 0))
                         for t in np.unique(hnt)))
        b2 = np.searchsorted(np.array(k2s), hnt)
        c2 = np.bincount(b2, minlength=len(k2s))
        off2 = 0
        for i, K2 in enumerate(k2s):
            rows = np.arange(off2, off2 + c2[i])
            off2 += c2[i]
            t2 = np.full((len(rows), K2), M, np.int32)  # M = zero partial
            d2 = hnt[rows]
            tot2 = int(d2.sum())
            if tot2:
                cum2 = np.cumsum(d2)
                base2 = np.repeat(cum2 - d2, d2)
                ar2 = np.arange(tot2)
                t2[np.repeat(np.arange(len(rows)), d2), ar2 - base2] = \
                    np.repeat(tile_start[rows], d2) + ar2 - base2
            lvl2.append(t2)
    return EllGraph(n=n, parts=parts, tiles=tiles, lvl2=lvl2,
                    seg_rows=seg_rows,
                    outdeg=deg_out[perm_order].astype(np.float32),
                    perm_order=perm_order, new_of_old=new_of_old, ks=ks)


def pack_seed_masks(g: EllGraph, rank_lists,
                    word_bits: int = 32) -> np.ndarray:
    """B seed rank lists (OLD rank space) → [n+1, B/word_bits] packed
    host mask in the permuted space, sentinel zero row last. B must be a
    multiple of `word_bits`. The device path takes 32-bit words
    (`put_mask`)."""
    B = len(rank_lists)
    if B % word_bits:
        raise ValueError("lane count must pack into mask words")
    dt = np.uint32 if word_bits == 32 else np.uint64
    m = np.zeros((g.n + 1, B // word_bits), dt)
    for q, ranks in enumerate(rank_lists):
        r = g.new_of_old[np.asarray(ranks, np.int64)]
        m[r, q // word_bits] |= dt(1 << (q % word_bits))
    return m


def put_mask(mask: np.ndarray, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A host uint32 mask as an int32 tensor on `device` (same bits).
    Always a copy: the recurse run updates its seed mask in place."""
    if mask.dtype != np.uint32:
        raise ValueError(f"device masks hold 32-bit words, got {mask.dtype}")
    return torch.from_numpy(np.ascontiguousarray(mask).view(np.int32)).to(
        resolve_device(device), copy=True)


def unpack_masks(g: EllGraph, mask, word_bits: int = 32) -> list:
    """[n+1, W] packed mask (numpy, or an int32 tensor) → list of B
    sorted OLD-rank arrays."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy().view(np.uint32)
    m = np.asarray(mask)[:g.n]
    dt = m.dtype.type
    out = []
    for q in range(m.shape[1] * word_bits):
        rows = np.nonzero(
            (m[:, q // word_bits] >> dt(q % word_bits)) & dt(1))[0]
        out.append(np.sort(g.perm_order[rows]).astype(np.int32))
    return out


@dataclass
class DeviceEll:
    """EllGraph's index arrays resident on one device (int32)."""

    n: int
    parts: list            # ("zero", None, rows) | ("ell", tensor, rows)
    tiles: object          # tensor [M, seg_tile] | None
    lvl2: list             # tensors [h_b, K2]
    seg_rows: int
    device: torch.device


def _checked(e: np.ndarray, hi: int) -> np.ndarray:
    """The kernel trusts its indices: check them once, here."""
    if e.size and (int(e.min()) < 0 or int(e.max()) > hi):
        raise ValueError(f"ELL index outside [0, {hi}]")
    return np.ascontiguousarray(e, np.int32)


def device_ell(g: EllGraph, device=DEFAULT_DEVICE) -> DeviceEll:
    dev = resolve_device(device)

    def put(e, hi):
        return torch.from_numpy(_checked(e, hi)).to(dev)

    M = g.tiles.shape[0] if g.tiles is not None else 0
    parts = [(kind, put(e, g.n) if e is not None else None, rows)
             for kind, e, rows in g.parts]
    return DeviceEll(
        n=g.n, parts=parts,
        tiles=put(g.tiles, g.n) if g.tiles is not None else None,
        lvl2=[put(t, M) for t in g.lvl2], seg_rows=g.seg_rows, device=dev)


def prepare_parts(dev: DeviceEll) -> dict:
    """The hop's plan: each block with the first row it writes in the
    next mask. Dense parts come first in permuted order, then the
    second-level combines (the heavy rows), then the sentinel row n —
    the reference's concatenation order.

    `levels` is the launch table's shape, width-free: level 1 holds the
    tiles into the partials, every dense class and the rows set to zero
    (the in-degree-0 class, the sentinel row n, the partials' zero row
    M); level 2 the combines that read the partials. `tables` caches
    each width's launch table (`hop_table`), built at its first hop."""
    parts = []
    row0 = 0
    for kind, e, rows in dev.parts:
        parts.append(("zero" if kind == "zero" or rows == 0 else "hop",
                      e, rows, row0))
        row0 += rows
    tiles = None
    lvl2 = []
    if dev.tiles is not None and dev.seg_rows:
        tiles = dev.tiles
        for t2 in dev.lvl2:
            lvl2.append((t2, row0))
            row0 += t2.shape[0]
    if row0 != dev.n:
        raise ValueError(f"ELL blocks cover {row0} rows, graph has {dev.n}")
    level1 = [(e, rows, r0, OUT) for kind, e, rows, r0 in parts
              if kind == "hop"]
    zeros = [(None, rows, r0, OUT) for kind, _e, rows, r0 in parts
             if kind == "zero" and rows]
    zeros.append((None, 1, dev.n, OUT))                    # sentinel row
    part_rows = 0
    if tiles is not None:
        M = tiles.shape[0]
        part_rows = M + 1
        # the tiles first: the launch's longest blocks start first
        level1.insert(0, (tiles, M, 0, PARTIALS))
        zeros.append((None, 1, M, PARTIALS))               # zero partial
    levels = [level1 + zeros]
    if lvl2:
        levels.append([(t2, t2.shape[0], r0, OUT) for t2, r0 in lvl2])
    return {"parts": parts, "tiles": tiles, "lvl2": lvl2, "n": dev.n,
            "device": dev.device, "levels": levels,
            "part_rows": part_rows, "tables": {}}


def hop_table(prepared, frontier: torch.Tensor, out: torch.Tensor,
              seen: torch.Tensor | None = None) -> HopTable:
    """The prepared graph's launch table for this hop's width, vector
    words and stream (`bucket_hop.table_key`), built once and cached in
    `prepared["tables"]`."""
    key = table_key(frontier, out, seen)
    tab = prepared["tables"].get(key)
    if tab is None:
        n = prepared["n"]
        tab = prepared["tables"][key] = build_table(
            prepared["levels"], key[0], key[1], prepared["device"],
            out_rows=n + 1, part_rows=prepared["part_rows"], src_rows=n + 1)
    return tab


def _ell_hop(prepared, frontier: torch.Tensor, hop=bucket_hop, *,
             flags: torch.Tensor | None = None,
             seen: torch.Tensor | None = None,
             out_flags: torch.Tensor | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """next[v] = OR of frontier[u] over in-neighbors u, by the graph's
    launch table (`hop_table`): the dense classes and the tile partials
    into a [M+1, W] scratch whose row M is zero, then the combines that
    read it, each entry writing its own rows of the [n+1, W] result.
    With `hop=bucket_hop` (the default) each level is one launch of the
    kernel on the card, the plain table walk on the CPU; any other `hop`
    (`bucket_hop_plain`, the one-bucket `bucket_hop` wrapped) walks the
    table entry by entry through it.

    `flags` [n+1] uint8 marks the frontier rows that may hold a bit (the
    launches skip the others); `out_flags` [n+1] uint8, when given,
    receives the result's row flags. With `seen` [n+1, W] the result is
    the first-visit set fresh = next & ~seen, and seen |= fresh in place;
    rows no bucket computes (the in-degree-0 class, the sentinel) are
    zero and leave seen as it was. The tile partials always carry flags,
    so the combines skip empty partials. `out`, a contiguous [n+1, W]
    int32 tensor, receives the result instead of a new one."""
    n = prepared["n"]
    W = frontier.shape[1]
    nxt = out if out is not None else torch.empty(
        (n + 1, W), dtype=torch.int32, device=frontier.device)
    tab = hop_table(prepared, frontier, nxt, seen)
    if hop is bucket_hop:
        return run_table(tab, frontier, nxt, flags=flags,
                         out_flags=out_flags, seen=seen)
    return walk_table(tab, frontier, nxt, hop, flags=flags,
                      out_flags=out_flags, seen=seen)


def row_flags(mask: torch.Tensor) -> torch.Tensor:
    """uint8 [rows]: 1 where a mask row has any bit set (the hop's
    occupancy flags; one device pass)."""
    return mask.any(1).view(torch.uint8)


COUNT_BLK = 1 << 15   # edge-counter node-block rows (bounds unpack memory)


def _count_mask(mask: torch.Tensor, outdeg: torch.Tensor, n: int):
    """Per-lane out-degree mass of a packed mask: Σ_v outdeg[v]·bit_q(v),
    int64. Lane bits unpack to float64 per COUNT_BLK rows and meet the
    degrees in one product; every partial sum is an integer below 2^53,
    so the result is exact."""
    W = mask.shape[1]
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    acc = torch.zeros(W * 32, dtype=torch.float64, device=mask.device)
    for lo in range(0, n, COUNT_BLK):
        hi = min(n, lo + COUNT_BLK)
        bits = ((mask[lo:hi, :, None] >> shifts) & 1).reshape(hi - lo,
                                                               W * 32)
        acc += outdeg[lo:hi] @ bits.to(torch.float64)
    return acc.round().to(torch.int64)


def _outdeg_tensor(outdeg, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(outdeg, np.float64)).to(device)


def make_ell_count(outdeg, n: int, device=DEFAULT_DEVICE):
    """The exact per-query edge counter over final masks:
    edges[q] = Σ outdeg[v]·[v ∈ seen \\ last] — every frontier the run
    expanded is exactly `seen` minus the never-expanded last fresh set.
    Returns count(last, seen) → int64 [B]."""
    od = _outdeg_tensor(outdeg, resolve_device(device))

    def count(last: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
        return _count_mask(seen & ~last, od, n)

    return count


def _check_mask(name: str, t, n: int, W: int, device) -> None:
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
            or tuple(t.shape) != (n + 1, W) or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{n + 1}, {W}] "
                         f"tensor on {device}")


def make_ell_recurse(dev: DeviceEll, outdeg, n: int, W: int,
                     count_edges: bool = True):
    """A depth-parameterised loop=false @recurse over a DeviceEll.
    Returns fn(mask0, depth, keep_hops=False) → (last [n+1, W],
    seen [n+1, W], edges [32·W] int64[, hops [depth, n+1, W]]).

    Each hop is `_ell_hop` with the first-visit epilogue fused into its
    launches (fresh = next & ~seen; seen |= fresh) and occupancy flags
    carried from hop to hop, so on the card the update runs no pass of
    its own and a hop reads only the frontier rows that hold bits.

    The seed mask is DONATED: `mask0` (an int32 tensor on the graph's
    device) becomes the `seen` carry and is updated in place. Hop 1
    gathers from a copy of it (a launch may not read the rows another
    launch's epilogue writes). Callers put a fresh mask per launch."""
    prepared = prepare_parts(dev)
    od = _outdeg_tensor(outdeg, dev.device) if count_edges else None

    def recurse(mask0: torch.Tensor, depth: int, keep_hops: bool = False):
        _check_mask("mask0", mask0, n, W, dev.device)
        seen = mask0                       # donated: updated in place
        frontier = mask0
        flags = row_flags(mask0)
        hops = []
        for _ in range(depth):
            if frontier is seen:
                # hop 1 gathers from the seed mask while its epilogue
                # updates seen in place: it reads a copy
                frontier = mask0.clone()
            fresh_flags = torch.empty(n + 1, dtype=torch.uint8,
                                      device=dev.device)
            fresh = _ell_hop(prepared, frontier, flags=flags, seen=seen,
                             out_flags=fresh_flags)
            frontier, flags = fresh, fresh_flags
            if keep_hops:
                # hops[h] = the FRESH mask after hop h+1 (first-visit
                # sets) — what tree reconstruction needs
                hops.append(fresh)
        last = frontier
        if count_edges:
            edges = _count_mask(seen & ~last, od, n)
        else:
            edges = torch.zeros(W * 32, dtype=torch.int64,
                                device=dev.device)
        if keep_hops:
            stacked = (torch.stack(hops) if hops else
                       torch.empty((0, n + 1, W), dtype=torch.int32,
                                   device=dev.device))
            return last, seen, edges, stacked
        return last, seen, edges

    return recurse


def make_ell_step(dev: DeviceEll, n: int, W: int, first_visit: bool = True,
                  hop=bucket_hop):
    """A RESUMABLE hop block: fn(frontier, seen, depth) → (frontier',
    seen', hops [depth, n+1, W]) in the graph's permuted space. Successive
    blocks of a staged traversal (the shortest-path lane groups of
    engine/batch.py) hand both carries forward.

    With `first_visit` each hop is `_ell_hop` with its fused epilogue:
    hops[h] is the first-visit set fresh = next & ~seen, and `seen` — a
    tensor apart from `frontier` (the kernel refuses shared memory) — is
    updated in place. With `first_visit=False` there is no `seen`
    operand: hops[h] is the FULL set reachable in exactly h+1 hops (the
    level DAG the k-shortest enumeration reads) and `seen` passes through
    untouched. Occupancy flags are carried from hop to hop; `frontier'`
    is hops[-1] (the input frontier when depth is 0). `hop` is the
    bucket launch (the plain version to compare against)."""
    prepared = prepare_parts(dev)

    def step(frontier: torch.Tensor, seen: torch.Tensor, depth: int):
        _check_mask("frontier", frontier, n, W, dev.device)
        _check_mask("seen", seen, n, W, dev.device)
        hops = torch.empty((depth, n + 1, W), dtype=torch.int32,
                           device=dev.device)
        flags = row_flags(frontier)
        for h in range(depth):
            out_flags = torch.empty(n + 1, dtype=torch.uint8,
                                    device=dev.device)
            frontier = _ell_hop(prepared, frontier, hop, flags=flags,
                                seen=seen if first_visit else None,
                                out_flags=out_flags, out=hops[h])
            flags = out_flags
        return frontier, seen, hops

    return step


def make_ell_tree(stages, n: int, W: int, hop=bucket_hop):
    """A level-TREE pipeline over lane-packed masks: the batched form of
    a whole nested query (engine/treebatch.py), 32·W queries per run.

    Every mask lives in the STORE's global rank space, [n+1, W] int32
    (row n the zero sentinel). Each stage's EllGraph has its own degree
    permutation, so a stage gathers its parent mask into its permuted
    space (`perm_in`), hops, and gathers back (`out_idx`); a hop stage
    then ANDs its filter mask.

    `stages` is a list of dicts:
      kind      "hop" | "recurse"
      prepared  prepare_parts output for the stage's graph
      perm_in   [n+1] int64 on the device: permuted row r ← global perm_in[r]
      out_idx   [n+1] int64 on the device: global row v ← permuted out_idx[v]
      parent    ("seed", slot) | ("stage", idx earlier in the list)
      filt      filter-mask slot | None (global space)
      depth     recurse only: hop count
      keep_hops recurse only: also return the per-hop first-visit masks

    A recurse stage scans in permuted space with the first-visit epilogue
    in the hop launches. Its filter keeps only allowed nodes fresh
    (fresh = next & ~seen & filt) without a filter operand in the kernel:
    the scan starts from seen' = seeds | ~filt, so the kernel's
    next & ~seen' is exactly that set, and seen = (seen' & filt) | seeds
    at the end keeps every fresh set (all inside filt) and the seeds
    (even where the filter excludes them). Two torch passes per stage,
    none per hop.

    Returns fn(seeds: tuple, filts: tuple) → a tuple with one entry per
    stage: hop → mask [n+1, W]; recurse → seen [n+1, W] (reachable set
    incl. seeds), or (seen, hops [depth, n+1, W]) with keep_hops. Seeds
    and filters are only read. `hop` is the bucket launch."""

    def run(seeds, filts):
        outs: list = []
        results: list = []
        for s in stages:
            par = s["parent"]
            parent = seeds[par[1]] if par[0] == "seed" else outs[par[1]]
            filt = filts[s["filt"]] if s["filt"] is not None else None
            device = parent.device
            pm = parent.index_select(0, s["perm_in"])    # global → permuted
            flags = row_flags(pm)
            if s["kind"] == "hop":
                out = _ell_hop(s["prepared"], pm, hop,
                               flags=flags).index_select(0, s["out_idx"])
                if filt is not None:
                    out &= filt
                outs.append(out)
                results.append(out)
                continue
            depth = s["depth"]
            hops_p = (torch.empty((depth, n + 1, W), dtype=torch.int32,
                                  device=device) if s["keep_hops"] else None)
            if filt is None:
                seen = pm.clone()
            else:
                filt_p = filt.index_select(0, s["perm_in"])
                seen = pm | ~filt_p
            frontier = pm
            for h in range(depth):
                fresh_flags = torch.empty(n + 1, dtype=torch.uint8,
                                          device=device)
                frontier = _ell_hop(
                    s["prepared"], frontier, hop, flags=flags, seen=seen,
                    out_flags=fresh_flags,
                    out=hops_p[h] if hops_p is not None else None)
                flags = fresh_flags
            if filt is not None:
                seen &= filt_p
                seen |= pm
            seen = seen.index_select(0, s["out_idx"])
            outs.append(seen)
            results.append(seen if hops_p is None else
                           (seen, hops_p.index_select(1, s["out_idx"])))
        return tuple(results)

    return run
