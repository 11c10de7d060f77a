"""Segment combine: per-hop neighbour-feature aggregation.

Port of `dgraph_tpu/ops/feat.py`. Given one traversal level's flat edge
slots `(nbrs, seg)` with a live prefix of `n_edges`, and a sorted
embedding stack (`store/vec.py` VecTablet tensors `subj`, `vecs`),
combine each segment's participating edges' feature rows with sum, mean
or max (the reference's `segment_combine` and `combine_edges` are one
function here: the live prefix is its argument). The contract is the
reference's:

* an edge participates when its neighbour has a row in the stack; edges
  aggregate per EDGE (a neighbour reached twice counts twice);
* `mean` is the f32 sum divided by the f32 participant count, one IEEE
  division;
* a segment with no participating edge gets the zero row; `ecnt` (live
  edges per segment) tells the caller which segments had edges at all.

On the card `segment_combine` launches the hand-written kernels of
`csrc/segment_combine.cu`: one pass groups the live edges (tablet rows,
segment offsets, and a list of the long segments), then one kernel folds
short segments a warp each and long ones (`LONG_MIN` edges or more) a
column tile per block through a shared-memory ring. Either way each
output element is folded in edge order by one thread: the result is the
same on every run and every CUDA-graph replay, and equals numpy's
sequential `np.add.at` / `np.maximum.at` (`engine/feat.py:host_combine`)
bit for bit for any float input. On the CPU the same call runs
`segment_combine_plain`, the reference's arithmetic in torch ops
(`searchsorted`, `index_add_`, `scatter_reduce`), which is exact against
the kernel for small-integer-valued features (sums are then exact in any
order). Which one runs depends only on where the tensors lie: a CUDA
tensor launches the kernel or raises. The reference's `mask_empty=False`
partials serve only its mesh route; the port's mesh route
(`engine/feat.py:_mesh_combine`) calls this function per shard and masks
its empty segments for the merge itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dgraph_tpu_torch.utils import kbuild

AGGS = ("sum", "mean", "max")
# `segment_combine` calls that launched the kernels on a CUDA tensor, one
# per call whatever the kernels inside it (eager calls, and each replay of
# a CUDA graph that holds the call: `count_replay`); chip_smoke.py zeroes
# it before a main path and reads it after
LAUNCHES = {"segment_combine": 0}
# calls recorded into a CUDA graph under capture (no launch): a graph's
# owner reads the growth over its capture as its launches per replay
RECORDED = {"segment_combine": 0}

# The kernels' compile-time plan (csrc/segment_combine.cu; checked against
# the library's own copy at load): group_edges runs THREADS threads a
# block; combine runs COMBINE_THREADS (five short-segment warps; on the
# long path four staging warps and one folding warp). A segment of at least LONG_MIN live
# edges takes the long path, one block per (segment, TILE_COLS-column
# tile) staging STAGE_ROWS-row stages through a STAGES-deep shared-memory
# ring of SMEM_BYTES.
THREADS = 256
COMBINE_THREADS = 160
LONG_MIN = 512
TILE_COLS = 8
STAGE_ROWS = 4096 // TILE_COLS
STAGES = 6
SMEM_BYTES = STAGES * STAGE_ROWS * TILE_COLS * 4
SMEM_LIMIT = 232_448          # shared memory one Hopper block may use
SMS = 132                     # H100 SXM streaming multiprocessors
GROUP_GRID_CAP = SMS * 8
COMBINE_GRID_CAP = SMS * 2    # two combine blocks fit on an SM
INT32_MAX = 2**31 - 1

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = kbuild.load("segment_combine")
        cfg = (ctypes.c_int32 * 7)()
        lib.dg_segment_combine_config(cfg)
        want = (THREADS, COMBINE_THREADS, LONG_MIN, TILE_COLS, STAGE_ROWS,
                STAGES, SMEM_BYTES)
        if tuple(cfg) != want:
            raise RuntimeError(f"segment_combine library plan {tuple(cfg)} "
                               f"!= the wrapper's {want}")
        f = lib.dg_segment_combine
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        f.argtypes = [P, I64, P, I64, I32, P, P, P, I64, P, I32, I32, I32, P,
                      I32, I32, P, P, P, P]
        f.restype = ctypes.c_int
        lib.dg_error_string.argtypes = [ctypes.c_int]
        lib.dg_error_string.restype = ctypes.c_char_p
        lib.dg_segment_combine_init.restype = ctypes.c_int
        rc = lib.dg_segment_combine_init()
        if rc:
            raise RuntimeError(f"segment_combine init failed: "
                               f"{lib.dg_error_string(rc).decode()} "
                               f"(cudaError {rc})")
        _fn = (f, lib.dg_error_string)
    return _fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def launch_plan(d: int, n_live_max: int, n_seg: int) -> dict:
    """The host side of one CUDA call: grids, the long path's column
    tiles and slot-list length, the scratch it needs (int32 words: tablet
    rows, segment offsets, slots) and the shared memory of a combine
    block. `n_live_max` is the live count, or the slot capacity when the
    count is a device tensor. Cached: callers must not change it."""
    tiles = _cdiv(d, TILE_COLS)
    slots = _cdiv(n_live_max, LONG_MIN)
    return {"tiles": tiles, "slots": slots, "long_min": LONG_MIN,
            "smem_bytes": SMEM_BYTES,
            "scratch": n_live_max + n_seg + 1 + slots,
            "group_grid": max(1, min(_cdiv(max(n_live_max, n_seg + 1),
                                           THREADS), GROUP_GRID_CAP)),
            "combine_grid": max(1, min(max(_cdiv(n_seg,
                                                COMBINE_THREADS // 32),
                                           slots * tiles),
                                       COMBINE_GRID_CAP))}


def _check(subj, vecs, nbrs, seg, n_seg: int, agg: str) -> None:
    dev = vecs.device
    for name, t, dtype, dim in (("subj", subj, torch.int32, 1),
                                ("vecs", vecs, torch.float32, 2),
                                ("nbrs", nbrs, torch.int32, 1),
                                ("seg", seg, torch.int32, 1)):
        if (t.dtype != dtype or t.dim() != dim or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if vecs.shape[0] != subj.shape[0] or vecs.shape[1] < 1:
        raise ValueError(f"vecs {tuple(vecs.shape)} must hold one row of "
                         f"width >= 1 per subj entry ({subj.shape[0]})")
    if nbrs.shape != seg.shape:
        raise ValueError(f"nbrs {tuple(nbrs.shape)} and seg "
                         f"{tuple(seg.shape)} differ")
    if agg not in AGGS:
        raise ValueError(f"agg must be one of {AGGS}, got {agg!r}")
    if n_seg < 0:
        raise ValueError(f"n_seg must be >= 0, got {n_seg}")


def _live(nbrs: torch.Tensor, n_edges) -> torch.Tensor:
    """The live-prefix mask of the edge slots; `n_edges` is an int or a
    0-d tensor on the slots' device (no host synchronisation)."""
    return torch.arange(nbrs.shape[0], dtype=torch.int32,
                        device=nbrs.device) < n_edges


def segment_combine_plain(subj, vecs, nbrs, seg, n_edges, n_seg: int,
                          agg: str):
    """The plain PyTorch version: `(out[n_seg, d] f32, cnt[n_seg] i32,
    ecnt[n_seg] i32)` for the edge slots below `n_edges`. Slots whose seg
    lies outside [0, n_seg) are dropped (the reference's `mode="drop"`
    scatter drops those past n_seg and wraps negative ones into the last
    segments; no caller of either package passes a negative seg)."""
    _check(subj, vecs, nbrs, seg, n_seg, agg)
    dev, rows, d = vecs.device, subj.shape[0], vecs.shape[1]
    valid = _live(nbrs, n_edges) & (seg >= 0) & (seg < n_seg)
    idx = torch.searchsorted(subj, nbrs).clamp_(0, max(rows - 1, 0))
    has = valid & (subj[idx] == nbrs) if rows else valid & False
    # dropped and non-participating slots go to a spare row n_seg
    tgt_e = torch.where(valid, seg, n_seg).long()
    tgt_p = torch.where(has, seg, n_seg).long()
    ecnt = torch.zeros(n_seg + 1, dtype=torch.int32, device=dev).index_add_(
        0, tgt_e, torch.ones_like(tgt_e, dtype=torch.int32))[:n_seg]
    cnt = torch.zeros(n_seg + 1, dtype=torch.int32, device=dev).index_add_(
        0, tgt_p, torch.ones_like(tgt_p, dtype=torch.int32))[:n_seg]
    got = vecs[idx.long()] if rows else torch.zeros(
        (nbrs.shape[0], d), dtype=torch.float32, device=dev)
    if agg == "max":
        out = torch.full((n_seg + 1, d), float("-inf"), dtype=torch.float32,
                         device=dev)
        out.scatter_reduce_(0, tgt_p[:, None].expand(-1, d), got, "amax")
        out = out[:n_seg]
    else:
        out = torch.zeros((n_seg + 1, d), dtype=torch.float32,
                          device=dev).index_add_(0, tgt_p, got)[:n_seg]
        if agg == "mean":
            out = out / cnt.clamp(min=1)[:, None].to(torch.float32)
    out = torch.where((cnt > 0)[:, None], out, 0.0)
    return out, cnt, ecnt


class Prepared:
    """One CUDA call of the kernels with everything set up before its
    launch: the grouping, the outputs and scratch (two `torch.empty`) and
    the launch plan. `launch()` runs the two kernels; `outputs` are
    `(out, cnt, ecnt)`."""

    def __init__(self, subj, vecs, nbrs, seg, n_edges, n_seg: int, agg: str,
                 seg_sorted: bool):
        _check(subj, vecs, nbrs, seg, n_seg, agg)
        dev = vecs.device
        if dev.type != "cuda":
            raise ValueError(f"the segment_combine kernels run on cuda, "
                             f"not {dev}")
        rows, d, e = subj.shape[0], vecs.shape[1], nbrs.shape[0]
        out = torch.empty((n_seg, d), dtype=torch.float32, device=dev)
        self.device = dev
        n_dev = order = None
        if isinstance(n_edges, torch.Tensor):
            if (n_edges.dim() != 0 or n_edges.device != dev
                    or n_edges.dtype not in (torch.int32, torch.int64)):
                raise ValueError(f"n_edges must be an int or a 0-d int32 / "
                                 f"int64 tensor on {dev}, got {n_edges.dtype}"
                                 f" {tuple(n_edges.shape)} on "
                                 f"{n_edges.device}")
            n_host, keys = e, seg
            if seg_sorted:
                n_dev = n_edges
            else:
                # dead slots sort past every segment
                keys, order = torch.sort(
                    torch.where(_live(nbrs, n_edges), seg, INT32_MAX),
                    stable=True)
        else:
            n_host = min(max(int(n_edges), 0), e)
            keys = seg if n_host == e else seg[:n_host]
            if not seg_sorted:
                keys, order = torch.sort(keys, stable=True)
        self.plan = launch_plan(d, n_host, n_seg)
        # cnt, ecnt, then the kernels' scratch: one allocation
        ints = torch.empty(2 * n_seg + self.plan["scratch"],
                           dtype=torch.int32, device=dev)
        cnt, ecnt, scratch = ints.split([n_seg, n_seg, self.plan["scratch"]])
        self.outputs = (out, cnt, ecnt)
        vec4 = (d % 4 == 0 and vecs.data_ptr() % 16 == 0
                and out.data_ptr() % 16 == 0)
        # the tensors the launch reads, held until it is enqueued
        self._hold = (subj, vecs, nbrs, keys, order, n_dev, scratch)
        self._args = (subj.data_ptr(), rows, vecs.data_ptr(), d, int(vec4),
                      nbrs.data_ptr(), keys.data_ptr() or None,
                      None if order is None else order.data_ptr(), n_host,
                      None if n_dev is None else n_dev.data_ptr(),
                      int(n_dev is not None and n_dev.dtype == torch.int64),
                      n_seg, AGGS.index(agg), scratch.data_ptr(),
                      self.plan["group_grid"], self.plan["combine_grid"],
                      out.data_ptr(), cnt.data_ptr(), ecnt.data_ptr())

    def launch(self) -> None:
        """Enqueue the kernels on the current stream and count the call:
        one in LAUNCHES, or in RECORDED under CUDA-graph capture."""
        fn, err_str = _kernel()
        index = self.device.index
        if index is None or index == torch.cuda.current_device():
            rc = fn(*self._args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(self.device):
                rc = fn(*self._args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"segment_combine launch failed: "
                               f"{err_str(rc).decode()} (cudaError {rc})")
        if torch.cuda.is_current_stream_capturing():
            RECORDED["segment_combine"] += 1
        else:
            LAUNCHES["segment_combine"] += 1


def segment_combine(subj, vecs, nbrs, seg, n_edges, n_seg: int, agg: str,
                    seg_sorted: bool = False):
    """`(out[n_seg, d] f32, cnt[n_seg] i32, ecnt[n_seg] i32)`: combine the
    feature rows of `nbrs[j]` into segment `seg[j]` for every edge slot
    j < `n_edges` (an int or a 0-d device tensor: the call needs no host
    synchronisation and can be captured in a CUDA graph). `subj` [rows]
    sorted unique int32 and `vecs` [rows, d] f32 are a tablet's tensors;
    `nbrs`, `seg` [e] int32. `seg_sorted` says the live prefix of `seg`
    is already non-decreasing (a hop's kept edges): then no torch op runs
    around the two kernels; otherwise a stable `torch.sort` groups the
    slots first. CPU tensors run `segment_combine_plain`. One call counts
    one launch in LAUNCHES (RECORDED under capture), whatever the number
    of kernels inside it."""
    dev = vecs.device
    if dev.type == "cpu":
        return segment_combine_plain(subj, vecs, nbrs, seg, n_edges, n_seg,
                                     agg)
    if dev.type != "cuda":
        raise ValueError(f"segment_combine runs on cuda or cpu, not {dev}")
    call = Prepared(subj, vecs, nbrs, seg, n_edges, n_seg, agg, seg_sorted)
    if n_seg:
        call.launch()
    return call.outputs


def count_replay(calls: int) -> None:
    """Count the launches of one replay of a CUDA graph that recorded
    `calls` segment_combine calls."""
    LAUNCHES["segment_combine"] += calls

