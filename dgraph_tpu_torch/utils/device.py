"""Device selection for the port's entry points.

Every entry point that places data takes an explicit `device`, default
`"cuda"`. Without a card it raises instead of quietly running on the
CPU; the CPU is used only when the caller names it (the tests do).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


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
