"""Node identity metrics: `build_info` and `process_uptime_s`.

Port of the identity half of `dgraph_tpu/server/fleet.py`: the gauges
every exposition render refreshes, so scrapes always carry a live
uptime. `build_info`'s labels are the package version, the torch
version and the device type the process serves on (`cuda` when a card
is present, else `cpu`), where the reference's name the jax version and
backend (ROADMAP Queue 3). The fleet snapshot and its fan-out over the
worker transport (`node_snapshot`, `fleet_snapshot`) come with the
cluster (ROADMAP Queue 1 item 9e).
"""

from __future__ import annotations

from dgraph_tpu_torch import __version__
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["build_labels", "refresh_identity_metrics"]

_START_MONO = dl.monotonic_s()
_BUILD: dict | None = None


def build_labels() -> dict:
    """The build_info identity labels, resolved once: package version,
    torch version and the device type."""
    global _BUILD
    if _BUILD is None:
        import torch
        _BUILD = {"version": __version__, "torch": torch.__version__,
                  "device": "cuda" if torch.cuda.is_available() else "cpu"}
    return _BUILD


def refresh_identity_metrics() -> None:
    """Set the build/uptime identity gauges. Called before every
    exposition render, so `process_uptime_s` is live, not a boot-time
    constant."""
    b = build_labels()
    METRICS.set_gauge("build_info", 1.0, version=b["version"],
                      torch=b["torch"], device=b["device"])
    METRICS.set_gauge("process_uptime_s",
                      round(dl.monotonic_s() - _START_MONO, 3))
