"""One ELL degree bucket's pull-hop: out[i] = OR_k frontier[nbr[i, k]].

Port of `dgraph_tpu/ops/pallas_hop.py:bucket_hop_pallas`. On the card
the hop is the hand-written CUDA kernel in `csrc/bucket_hop.cu` (its
source note says what bounds it and how it is laid out); on the CPU the
same function runs as `bucket_hop_plain`. Which one runs depends only on
where the tensors lie: a CUDA tensor launches the kernel or raises, with
no fallback and no switch.

Beyond the reference's hop, a launch can
  * skip empty frontier rows: `flags` [rows] uint8 marks the rows that
    may hold a bit (0 only on an all-zero row); a row flagged 0
    contributes nothing and is never read;
  * write `out_flags` [out rows] uint8 for the rows it writes (1 iff the
    stored row has a bit set), so the next hop can skip them;
  * run the first-visit epilogue of `make_ell_recurse`: with `seen`
    given it stores fresh = nxt & ~seen instead of nxt and ORs fresh into
    `seen` in place (same rows as `out`).

Lane words are int32 tensors carrying the reference's uint32 bits.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.utils import kbuild

# kernel launches by this wrapper (one per non-empty bucket on a CUDA
# tensor); chip_smoke.py zeroes it before the main path and reads it after
LAUNCHES = {"bucket_hop": 0}
# rows the plain version gathers at once, as [rows, K, W] int32 words
PLAIN_GATHER_BYTES = 64 << 20

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = kbuild.load("bucket_hop")
        f = lib.dg_bucket_hop
        f.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.dg_error_string.argtypes = [ctypes.c_int]
        lib.dg_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.dg_error_string)
    return _fn


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors on one device share a byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def _check(nbr, frontier, out, row0, flags, out_flags, seen):
    # runs once per bucket launch (41 per hop on the bench graph): kept
    # to plain attribute reads, the host's share of a hop
    dev = frontier.device
    for name, t in (("nbr", nbr), ("frontier", frontier), ("out", out),
                    ("seen", seen)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 2
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for name, t, rows in (("flags", flags, frontier.shape[0]),
                          ("out_flags", out_flags, out.shape[0])):
        if t is not None and (t.dtype != torch.uint8 or t.shape != (rows,)
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous uint8 [{rows}] "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    n_b, K = nbr.shape
    if K < 1:
        raise ValueError("a hop bucket needs K >= 1")
    if out.shape[1] != frontier.shape[1]:
        raise ValueError(f"out width {out.shape[1]} != frontier width "
                         f"{frontier.shape[1]}")
    if seen is not None and seen.shape != out.shape:
        raise ValueError(f"seen {tuple(seen.shape)} must match out "
                         f"{tuple(out.shape)}")
    if row0 < 0 or row0 + n_b > out.shape[0]:
        raise ValueError(f"rows [{row0}, {row0 + n_b}) outside out's "
                         f"{out.shape[0]} rows")
    # other blocks still gather from the frontier while a launch writes
    # out, seen and out_flags: none of those may share its memory
    for a, b, names in ((frontier, out, "frontier and out"),
                        (frontier, seen, "frontier and seen"),
                        (out, seen, "out and seen"),
                        (flags, out_flags, "flags and out_flags")):
        if a is not None and b is not None and _overlap(a, b):
            raise ValueError(f"{names} share memory")


def _out_for(nbr, frontier, out):
    if out is None:
        out = torch.empty((nbr.shape[0], frontier.shape[1]),
                          dtype=torch.int32, device=frontier.device)
    return out


def bucket_hop_plain(nbr: torch.Tensor, frontier: torch.Tensor,
                     out: torch.Tensor | None = None, row0: int = 0, *,
                     flags: torch.Tensor | None = None,
                     out_flags: torch.Tensor | None = None,
                     seen: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: gather frontier[nbr] (rows flagged 0 as
    zero) and OR-fold over K, then the first-visit epilogue when `seen`
    is given, then the flags of the stored rows. Same contract as
    `bucket_hop`. The gather takes up to PLAIN_GATHER_BYTES of rows at a
    time, as [rows, K, W], and folds K by halving (log2 K ORs)."""
    out = _out_for(nbr, frontier, out)
    _check(nbr, frontier, out, row0, flags, out_flags, seen)
    n_b, K = nbr.shape
    W = frontier.shape[1]
    idx = nbr.long()
    live = flags.bool() if flags is not None else None
    acc = torch.empty((n_b, W), dtype=torch.int32, device=frontier.device)
    step = max(1, PLAIN_GATHER_BYTES // (4 * K * W))
    for r0 in range(0, n_b, step):
        sel = idx[r0:r0 + step]
        rows = frontier[sel]                               # [r, K, W]
        if live is not None:
            rows.masked_fill_(~live[sel][:, :, None], 0)
        # graftlint: allow(hot-loop-checkpoint): O(log K) halving of the
        # bucket's slot axis
        while rows.shape[1] > 1:
            half = rows.shape[1] // 2
            folded = rows[:, :half] | rows[:, half:2 * half]
            if rows.shape[1] % 2:
                folded[:, 0] |= rows[:, -1]
            rows = folded
        acc[r0:r0 + step] = rows[:, 0]
    if seen is not None:
        acc &= ~seen[row0:row0 + n_b]
        seen[row0:row0 + n_b] |= acc
    out[row0:row0 + n_b] = acc
    if out_flags is not None:
        out_flags[row0:row0 + n_b] = acc.ne(0).any(1)
    return out


def bucket_hop(nbr: torch.Tensor, frontier: torch.Tensor,
               out: torch.Tensor | None = None, row0: int = 0, *,
               flags: torch.Tensor | None = None,
               out_flags: torch.Tensor | None = None,
               seen: torch.Tensor | None = None) -> torch.Tensor:
    """out[row0 + i, :] = OR_k frontier[nbr[i, k], :] for one bucket.

    `nbr` [n_b, K] int32, every entry a row of `frontier` (sentinel rows
    index an all-zero row); `frontier` [rows, W] int32; `out` [*, W]
    int32, allocated as [n_b, W] when None. `flags` [rows] uint8: rows
    flagged 0 are taken as empty and not read. `out_flags` [out rows]
    uint8: written for the bucket's rows. `seen` (shape of `out`): store
    fresh = nxt & ~seen and set seen |= fresh on the bucket's rows. The
    frontier must not share memory with out or seen. Returns `out`. A
    bucket with n_b == 0 launches nothing."""
    out = _out_for(nbr, frontier, out)
    dev = frontier.device
    if dev.type == "cpu":
        return bucket_hop_plain(nbr, frontier, out, row0, flags=flags,
                                out_flags=out_flags, seen=seen)
    if dev.type != "cuda":
        raise ValueError(f"bucket_hop runs on cuda or cpu, not {dev}")
    _check(nbr, frontier, out, row0, flags, out_flags, seen)
    n_b, K = nbr.shape
    if n_b == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        rc = fn(nbr.data_ptr(), n_b, K, frontier.data_ptr(), ptr(flags),
                frontier.shape[1], out.data_ptr(), ptr(out_flags), ptr(seen),
                row0, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"bucket_hop launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    LAUNCHES["bucket_hop"] += 1
    return out
