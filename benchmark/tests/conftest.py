"""Shared fixtures of the benchmark's CPU tests: tiny sizes of each
cell, and the card check that `cuda`-marked tests take."""

from __future__ import annotations

import time

import pytest

TINY = {
    "graph500-s20.recurse4-l4096": {"scale": 9, "lanes": 64,
                                    "check_lanes": 10_000,
                                    "warm_batches": 1, "trace_batches": 1},
    "snb-sf1-rag.knn-c8": {"sf": 0.01, "check_requests": 10_000,
                           "warm_per_template": 1, "warm_seconds": 0.05,
                           "trace_seconds": 0.2},
}


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_run(workload: str, seed: int = 20240611, seconds: float = 0.4,
             trace: bool = False, **extra) -> dict:
    """One run of `workload` on the CPU at its tiny size."""
    from benchmark import harness, run
    over = dict(TINY[workload], **extra)
    return run.run_cell(harness.manifest(candidates=True), workload, seed,
                        seconds, trace, "cpu", time.perf_counter(),
                        overrides=over)
