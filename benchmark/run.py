"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the configuration's family builds the inputs from the seed and
loads them into the port; the traffic's driver warms up the shapes the
cell uses) is timed from process start to the window's start. The
window runs for `--seconds`; with `--trace 1` part of it runs under
torch.profiler and the result holds the cell's per-layer metrics
instead of its end-to-end ones. Once the window has closed and the
device's peak memory is read, the program's state is freed and the
plain reference judges what the window served. The numbers compared
and their limits end standard error and the result line. Exits 3 and
prints no result without the CUDA devices the cell asks for, and 4 if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

from benchmark import harness


def run_cell(man: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, setup_t0: float,
             overrides: dict | None = None) -> dict:
    """Everything but the device check and the printing: returns the
    result line's fields."""
    import torch

    cell, cfg, traffic = harness.cell_of(man, workload)
    for key, val in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = val
    family = importlib.import_module("benchmark.families." + cfg["family"])
    driver = importlib.import_module("benchmark.drivers." + traffic["driver"])
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    system = family.build(cfg, seed, device, traffic)
    tracer = harness.Tracer(trace, device)
    tracer.prime()
    out = driver.run(system, traffic, seconds, seed, tracer)
    setup_s = out["t_start"] - setup_t0
    tracer.finish(out.get("trace", {}).get("timeline"))
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    system.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = family.reference(system, device)
    ctx = {"busy_s": tracer.busy_s, "window_s": tracer.window_s,
           "device_events": tracer.device_events}
    checks = driver.check(system, reference, traffic, out, seed, ctx)
    checks["failed"] = {"value": out["failed"], "limit": 0}
    ctx["seconds"] = {"setup": setup_s, "window": out["window_s"],
                      "reference": time.perf_counter() - t_ref}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        for m in harness.reported(man, workload, "per_layer"):
            v = harness.read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in harness.reported(man, workload, "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = tracer.busy_s
        dev["window_s"] = tracer.window_s
    return {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev,
            "breakdown": tracer.breakdown() if trace else None,
            "checks": checks, "checked": ctx.get("checked", 0),
            "seconds": ctx["seconds"],
            "diag": {**getattr(system, "phases", {}), **out.get("diag", {})}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    setup_t0 = time.perf_counter() - harness.process_age_s()
    harness.cache_dirs()
    man = harness.manifest()
    cell, _cfg, _traffic = harness.cell_of(man, args.workload)

    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    res = run_cell(man, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", setup_t0)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 4
    print(f"checked {res['checked']} answers; attempted "
          f"{res['attempted']}, failed {res['failed']}; seconds "
          f"{json.dumps(res['seconds'])}; {json.dumps(res['diag'])}",
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(harness.result_line(res["correct"], res["attempted"],
                              res["failed"], res["metrics"], res["device"],
                              res["breakdown"], res["checks"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
