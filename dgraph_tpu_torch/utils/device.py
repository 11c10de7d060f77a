"""Device selection for the port's entry points.

Every entry point that places data takes an explicit `device`, default
`"cuda"`. Without a card it raises instead of quietly running on the
CPU; the CPU is used only when the caller names it (the tests do).

`DEVICE_WIDE` serializes what acts on the whole card against a CUDA-graph
capture. The HTTP front end serves each request on its own thread, so a
capture (`engine/fused.py`) can overlap other requests' work. Captures
run in PyTorch's "thread_local" capture mode on a non-blocking stream:
another thread's launches, allocations and copies neither join nor
invalidate the capture. Three kinds of call still may not run while one
is underway: a second capture (its `torch.cuda.graph` entry synchronizes
the device and empties the allocator's cache); `torch.cuda.empty_cache`
or `torch.cuda.synchronize` from any thread (the caching allocator
asserts that no capture is underway when it releases its cache); and
work on a stream from PyTorch's round-robin stream pool, which can hand
out the very stream a capture records (the whole-block programs'
warm-ups). Each of them runs under this lock, and so does a capture.
"""

from __future__ import annotations


import torch

from dgraph_tpu_torch.utils import locks

DEFAULT_DEVICE = "cuda"

# reentrant: a capture's own clean-up empties the cache under it
DEVICE_WIDE = locks.make_rlock("device.wide")


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no card
    is present."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if d.type == "cuda" and d.index is None:
        # tensors report an indexed device; compare like with like
        d = torch.device("cuda", torch.cuda.current_device())
    return d
