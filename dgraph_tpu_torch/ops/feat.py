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

On the card `segment_combine` launches the hand-written kernel of
`csrc/segment_combine.cu`, which sums each segment in edge order: its
result is the same on every run and every CUDA-graph replay, and equals
numpy's sequential `np.add.at` (`engine/feat.py:host_combine`) bit for
bit for any float input. On the CPU the same call runs
`segment_combine_plain`, the reference's arithmetic in torch ops
(`searchsorted`, `index_add_`, `scatter_reduce`), which is exact against
the kernel for small-integer-valued features (sums are then exact in any
order). Which one runs depends only on where the tensors lie: a CUDA
tensor launches the kernel or raises. The `mask_empty=False` partials of
the reference serve only its mesh route (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.utils import kbuild

AGGS = ("sum", "mean", "max")
# kernel launches by `segment_combine` on a CUDA tensor (eager calls, and
# each replay of a CUDA graph that holds the kernel: `count_replay`);
# chip_smoke.py zeroes it before a main path and reads it after
LAUNCHES = {"segment_combine": 0}
# calls recorded into a CUDA graph under capture (no launch): a graph's
# owner reads the growth over its capture as its launches per replay
RECORDED = {"segment_combine": 0}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = kbuild.load("segment_combine")
        f = lib.dg_segment_combine
        f.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.dg_error_string.argtypes = [ctypes.c_int]
        lib.dg_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.dg_error_string)
    return _fn


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
    lies outside [0, n_seg) are dropped, as the reference's
    `mode="drop"` scatter drops them."""
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


def segment_combine(subj, vecs, nbrs, seg, n_edges, n_seg: int, agg: str,
                    seg_sorted: bool = False):
    """`(out[n_seg, d] f32, cnt[n_seg] i32, ecnt[n_seg] i32)`: combine the
    feature rows of `nbrs[j]` into segment `seg[j]` for every edge slot
    j < `n_edges` (an int or a 0-d device tensor: the call needs no host
    synchronisation and can be captured in a CUDA graph). `subj` [rows]
    sorted unique int32 and `vecs` [rows, d] f32 are a tablet's tensors;
    `nbrs`, `seg` [e] int32. `seg_sorted` says the live prefix of `seg`
    is already non-decreasing (a hop's kept edges), which spares the
    stable grouping sort. CPU tensors run `segment_combine_plain`."""
    dev = vecs.device
    if dev.type == "cpu":
        return segment_combine_plain(subj, vecs, nbrs, seg, n_edges, n_seg,
                                     agg)
    if dev.type != "cuda":
        raise ValueError(f"segment_combine runs on cuda or cpu, not {dev}")
    _check(subj, vecs, nbrs, seg, n_seg, agg)
    rows, d, e = subj.shape[0], vecs.shape[1], nbrs.shape[0]
    out = torch.empty((n_seg, d), dtype=torch.float32, device=dev)
    cnt = torch.empty(n_seg, dtype=torch.int32, device=dev)
    ecnt = torch.empty(n_seg, dtype=torch.int32, device=dev)
    if n_seg == 0:
        return out, cnt, ecnt
    # group the live slots by segment, stably: dead and out-of-range
    # slots take key n_seg and sort past every segment
    live = _live(nbrs, n_edges) & (seg >= 0) & (seg < n_seg)
    key = torch.where(live, seg, n_seg)
    order = None
    if not seg_sorted:
        key, order = torch.sort(key, stable=True)
    seg_off = torch.searchsorted(
        key, torch.arange(n_seg + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    scratch = torch.empty(e, dtype=torch.int32, device=dev)
    vec4 = (d % 4 == 0 and vecs.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        rc = fn(subj.data_ptr(), rows, vecs.data_ptr(), d, int(vec4),
                nbrs.data_ptr(), None if order is None else order.data_ptr(),
                e, seg_off.data_ptr(), n_seg, AGGS.index(agg),
                scratch.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                ecnt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"segment_combine launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    if torch.cuda.is_current_stream_capturing():
        RECORDED["segment_combine"] += 1
    else:
        LAUNCHES["segment_combine"] += 1
    return out, cnt, ecnt


def count_replay(calls: int) -> None:
    """Count the launches of one replay of a CUDA graph that recorded
    `calls` segment_combine calls."""
    LAUNCHES["segment_combine"] += calls

