"""Bench regression gate: diff two BENCH JSON documents, fail on drift.

Port of `dgraph_tpu/analysis/compare.py`; nothing here is specific to
either package.

`python -m dgraph_tpu_torch.analysis --bench-compare OLD.json NEW.json`
flattens both documents to dotted-path -> number, keeps the paths BOTH
runs carry, and judges each watched path by its direction:

* throughput-like (`value` = edges/s, `shed_precision`) — a DROP past
  the threshold is a regression;
* latency/launch-like (any `*_us` percentile, `mean_kernel_launches`)
  — a RISE past the threshold is a regression.

Unwatched keys (stage wall-times, counters, configs) are ignored: they
are either noisy or not quality signals. Exit status mirrors the lint
CLI: 0 = within threshold, 1 = regression(s), 2 = unreadable input.
The comparison is pure arithmetic over the shared keys — no reruns, no
statistics — so it is deterministic given the two files and usable as
a CI gate between a base-branch bench artifact and the PR's.
"""

from __future__ import annotations

import json
import pathlib

__all__ = ["flatten", "direction", "compare", "bench_compare_main"]

# leaves where HIGHER is better (throughput / precision)
_HIGHER = frozenset({"value", "shed_precision", "edges_per_s",
                     "feature_bytes_per_s"})
# leaves where LOWER is better, beyond the `*_us` suffix rule
_LOWER = frozenset({"mean_kernel_launches", "launches_per_query"})


def flatten(doc, prefix: str = "") -> dict[str, float]:
    """BENCH JSON -> {dotted.path: number}. Non-numeric leaves and
    bools are dropped; list indices become path segments so repeated
    stages stay addressable."""
    out: dict[str, float] = {}
    if isinstance(doc, dict):
        for k, v in doc.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            out.update(flatten(v, f"{prefix}{i}."))
    elif isinstance(doc, (int, float)) and not isinstance(doc, bool):
        out[prefix.rstrip(".")] = float(doc)
    return out


def direction(path: str) -> str | None:
    """'higher' / 'lower' for watched paths, None for ignored ones."""
    leaf = path.rsplit(".", 1)[-1]
    if leaf in _HIGHER:
        return "higher"
    if leaf in _LOWER or leaf.endswith("_us"):
        return "lower"
    return None


def compare(old: dict, new: dict,
            threshold: float = 0.10) -> list[dict]:
    """Per-shared-watched-key verdicts, regressions first. Each row:
    {key, direction, old, new, delta_frac, regressed}."""
    fo, fn = flatten(old), flatten(new)
    rows = []
    for key in sorted(set(fo) & set(fn)):
        d = direction(key)
        if d is None:
            continue
        ov, nv = fo[key], fn[key]
        delta = (nv - ov) / ov if ov else (0.0 if nv == ov else
                                           float("inf"))
        regressed = (delta > threshold if d == "lower"
                     else delta < -threshold)
        rows.append({"key": key, "direction": d, "old": ov, "new": nv,
                     "delta_frac": round(delta, 4)
                     if delta != float("inf") else delta,
                     "regressed": regressed})
    rows.sort(key=lambda r: (not r["regressed"], r["key"]))
    return rows


def bench_compare_main(old_path: str, new_path: str,
                       threshold: float, fmt: str = "text") -> int:
    try:
        old = json.loads(pathlib.Path(old_path).read_text())
        new = json.loads(pathlib.Path(new_path).read_text())
    except (OSError, ValueError) as e:
        print(f"bench-compare: cannot read input: {e}")
        return 2
    rows = compare(old, new, threshold)
    bad = [r for r in rows if r["regressed"]]
    if fmt == "json":
        print(json.dumps({"threshold": threshold, "rows": rows,
                          "regressions": len(bad)}, indent=2))
    else:
        for r in rows:
            mark = "REGRESSION" if r["regressed"] else "ok"
            print(f"{mark:>10}  {r['key']}  {r['old']:g} -> "
                  f"{r['new']:g}  ({r['delta_frac']:+.1%}, "
                  f"{r['direction']} is better)")
        print(f"bench-compare: {len(bad)} regression(s) past "
              f"{threshold:.0%} over {len(rows)} shared key(s)")
    return 1 if bad else 0
