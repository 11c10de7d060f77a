"""Leveled logging wrappers.

Port of `dgraph_tpu/utils/logging.py`, rooted at the logger
"dgraph_tpu_torch". Reference parity: `x/log.go` glog-style leveled logging. Thin stdlib
`logging` setup with the reference's severity prefixes, so operator
tooling that greps I/W/E lines keeps working.
"""

from __future__ import annotations

import logging
import sys

_FMT = "%(levelname).1s%(asctime)s %(name)s %(message)s"
_DATEFMT = "%m%d %H:%M:%S"

_configured = False


def setup(level: str = "info") -> None:
    global _configured
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    root = logging.getLogger("dgraph_tpu_torch")
    root.handlers[:] = [h]
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    _configured = True


def get(name: str) -> logging.Logger:
    if not _configured:
        setup()
    return logging.getLogger(f"dgraph_tpu_torch.{name}")
