"""One ELL degree bucket's pull-hop: out[i] = OR_k frontier[nbr[i, k]].

Port of `dgraph_tpu/ops/pallas_hop.py:bucket_hop_pallas`. On the card
the hop is the hand-written CUDA kernel in `csrc/bucket_hop.cu` (its
source note says what bounds it and how it is laid out); on the CPU the
same function runs as `bucket_hop_plain`. Which one runs depends only on
where the tensors lie: a CUDA tensor launches the kernel or raises, with
no fallback and no switch.

Lane words are int32 tensors carrying the reference's uint32 bits.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.utils import kbuild

# kernel launches by this wrapper (one per non-empty bucket on a CUDA
# tensor); chip_smoke.py zeroes it before the main path and reads it after
LAUNCHES = {"bucket_hop": 0}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = kbuild.load("bucket_hop")
        f = lib.dg_bucket_hop
        f.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.dg_error_string.argtypes = [ctypes.c_int]
        lib.dg_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.dg_error_string)
    return _fn


def _check(nbr, frontier, out, row0):
    for name, t in (("nbr", nbr), ("frontier", frontier), ("out", out)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != frontier.device:
            raise ValueError(f"{name} is on {t.device}, frontier on "
                             f"{frontier.device}")
    n_b, K = nbr.shape
    if K < 1:
        raise ValueError("a hop bucket needs K >= 1")
    if out.shape[1] != frontier.shape[1]:
        raise ValueError(f"out width {out.shape[1]} != frontier width "
                         f"{frontier.shape[1]}")
    if row0 < 0 or row0 + n_b > out.shape[0]:
        raise ValueError(f"rows [{row0}, {row0 + n_b}) outside out's "
                         f"{out.shape[0]} rows")


def bucket_hop_plain(nbr: torch.Tensor, frontier: torch.Tensor,
                     out: torch.Tensor | None = None,
                     row0: int = 0) -> torch.Tensor:
    """The plain PyTorch version: gather frontier[nbr] and OR-fold over K.
    Same contract as `bucket_hop`."""
    if out is None:
        out = torch.empty((nbr.shape[0], frontier.shape[1]),
                          dtype=torch.int32, device=frontier.device)
    _check(nbr, frontier, out, row0)
    n_b, K = nbr.shape
    idx = nbr.long()
    acc = frontier[idx[:, 0]]
    for k in range(1, K):
        acc |= frontier[idx[:, k]]
    out[row0:row0 + n_b] = acc
    return out


def bucket_hop(nbr: torch.Tensor, frontier: torch.Tensor,
               out: torch.Tensor | None = None,
               row0: int = 0) -> torch.Tensor:
    """out[row0 + i, :] = OR_k frontier[nbr[i, k], :] for one bucket.

    `nbr` [n_b, K] int32, every entry a row of `frontier` (sentinel rows
    index an all-zero row); `frontier` [rows, W] int32; `out` [*, W]
    int32, allocated as [n_b, W] when None. Returns `out`. A bucket with
    n_b == 0 launches nothing."""
    if out is None:
        out = torch.empty((nbr.shape[0], frontier.shape[1]),
                          dtype=torch.int32, device=frontier.device)
    if frontier.device.type == "cpu":
        return bucket_hop_plain(nbr, frontier, out, row0)
    if frontier.device.type != "cuda":
        raise ValueError(f"bucket_hop runs on cuda or cpu, not "
                         f"{frontier.device}")
    _check(nbr, frontier, out, row0)
    n_b, K = nbr.shape
    if n_b == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(frontier.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(nbr.data_ptr(), n_b, K, frontier.data_ptr(),
                frontier.shape[1], out.data_ptr(), row0, stream)
    if rc:
        raise RuntimeError(f"bucket_hop launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    LAUNCHES["bucket_hop"] += 1
    return out
