"""Batches of lane-packed depth-bounded traversals, in a closed loop
with one client.

Each batch holds `lanes` traversals with one root each, drawn fresh from
the seed among the vertices of degree >= 1, and runs the port's entry
as a batch is served: `pack_seed_masks` -> `put_mask` -> the recurse
closure -> the count -> the per-lane counts on the host. The window
runs batches until `seconds` have passed and ends with the last one;
`edges_per_s` is every lane's count over the window's seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.reference import bounds

WARM = 1          # root streams: warm-up batches, window batches,
WINDOW = 2        # the sample of lanes checked
SAMPLE = 3


def rng(seed: int, stream: int, index: int = 0):
    return np.random.default_rng([int(seed) % (1 << 64), stream, index])


def roots_of(candidates: np.ndarray, lanes: int, seed: int, stream: int,
             b: int) -> np.ndarray:
    return candidates[rng(seed, stream, b).integers(0, len(candidates),
                                                    lanes)]


def sample_lanes(seed: int, batches: int, lanes: int, check: int):
    """(batch, lane) indices of the lanes checked, drawn from the seed."""
    total = batches * lanes
    pick = np.sort(rng(seed, SAMPLE).choice(total, min(check, total),
                                            replace=False))
    return pick // lanes, pick % lanes


def _sync(system) -> None:
    if system.device.startswith("cuda"):
        torch.cuda.synchronize()


def _batch(system, roots, depth: int, spans: dict | None):
    t0 = time.perf_counter()
    with record_function("bench.seed_masks"):
        m = system.put(system.pack(roots))
        if spans is not None:
            _sync(system)
            spans.setdefault("bench.seed_masks", []).append(
                time.perf_counter() - t0)
    with record_function("bench.recurse"):
        last, seen = system.recurse(m, depth)[:2]
    with record_function("bench.count"):
        counts = system.count(last, seen).cpu().numpy()
    return counts


def run(system, traffic: dict, seconds: float, seed: int, tracer) -> dict:
    t_warm = time.perf_counter()
    lanes, depth = int(traffic["lanes"]), int(traffic["depth"])
    for b in range(int(traffic["warm_batches"])):
        _batch(system, roots_of(system.candidates, lanes, seed, WARM, b),
               depth, None)
    _sync(system)
    roots, counts, spans, errors = [], [], {}, []
    failed = 0
    t_start = time.perf_counter()
    system.phases["warm_s"] = t_start - t_warm

    ends = []

    def batches(spans, more):
        nonlocal failed
        while more():
            b = len(roots)
            r = roots_of(system.candidates, lanes, seed, WINDOW, b)
            try:
                c = _batch(system, r, depth, spans)
            except Exception as e:   # noqa: BLE001 — a raise fails its lanes
                failed += lanes
                errors.append(repr(e)[:300])
                c = np.full(lanes, -1, np.int64)
            roots.append(r)
            counts.append(c)
            ends.append(time.perf_counter())

    def running():      # the window holds one batch at least
        return not roots or time.perf_counter() - t_start < seconds

    traced = int(traffic["trace_batches"]) if tracer.enabled else 0
    if traced:
        with tracer.window():
            batches(spans, lambda: len(roots) < traced and running())
    traced = len(roots)
    batches(None, running)
    b = len(roots)
    window_s = time.perf_counter() - t_start
    total = int(sum(int(c[c >= 0].sum()) for c in counts))
    batch_ms = np.diff([t_start] + ends) * 1e3
    return {"t_start": t_start, "window_s": window_s,
            "attempted": b * lanes, "failed": failed,
            "e2e": {"edges_per_s": total / window_s},
            "roots": roots, "counts": counts, "traced": traced,
            "spans": spans, "diag": {"errors": errors[:3],
                                     "batch_ms": _quartiles(batch_ms)}}


def _quartiles(xs) -> list:
    """[min, q1, median, q3, max] of a diagnostic series."""
    return np.percentile(xs, [0, 25, 50, 75, 100]).tolist() if len(xs) \
        else []


def check(system, reference, traffic: dict, out: dict, seed: int,
          ctx: dict) -> dict:
    """The lanes checked against the plain reference, and, for the
    traced batches, each hop's least time from its occupancy."""
    lanes, depth = int(traffic["lanes"]), int(traffic["depth"])
    bi, li = sample_lanes(seed, len(out["roots"]), lanes,
                          int(traffic["check_lanes"]))
    roots = np.array([out["roots"][b][q] for b, q in zip(bi, li)])
    got = np.array([out["counts"][b][q] for b, q in zip(bi, li)])
    want = reference.counts(roots, depth)
    off = int(np.sum(got != want))
    ctx["host_spans"] = out["spans"]
    bound_s = 0.0
    for b in range(out["traced"]):
        for hop in reference.occupancy(out["roots"][b], depth):
            bound_s += bounds.hop_bound(system.n, reference.nnz, lanes // 32,
                                        **hop)["bound_s"]
    ctx["hop_bound_s"] = bound_s if out["traced"] else None
    ctx["checked"] = int(len(roots))
    return {"lanes_off": {"value": off,
                          "limit": traffic["limits"]["lanes_off"]}}


def control(inputs, reference, traffic: dict, seed: int,
            batches: int) -> dict:
    """The control's reading: the lanes a run of `batches` batches
    checks, counted by the reference in float32, judged against the
    exact counts."""
    lanes, depth = int(traffic["lanes"]), int(traffic["depth"])
    bi, li = sample_lanes(seed, batches, lanes, int(traffic["check_lanes"]))
    by_batch = {b: roots_of(inputs.candidates, lanes, seed, WINDOW, b)
                for b in set(bi.tolist())}
    roots = np.array([by_batch[b][q] for b, q in zip(bi.tolist(),
                                                     li.tolist())])
    want = reference.counts(roots, depth)
    got = reference.counts(roots, depth, precision="float32")
    return {"lanes_off": int(np.sum(got.astype(np.float64) != want)),
            "checked": int(len(roots)), "max_count": int(want.max())}
