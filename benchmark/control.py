"""The controls of `correct`: the plain reference put in the program's
place, computed in the precision below the configuration's, and judged
as a run judges the program. A sound comparison reads it as not
correct. The benchmark's own runs never run it.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --count N

`--count` is what one run of the cell serves: batches for a traversal
cell, requests for a served one. Prints one JSON line per seed with the
numbers compared beside their limits.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from benchmark import harness


def readings(workload: str, seeds: list, count: int, device: str,
             overrides: dict | None = None) -> list:
    man = harness.manifest(candidates=True)
    _cell, cfg, traffic = harness.cell_of(man, workload)
    for key, val in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = val
    family = importlib.import_module("benchmark.families." + cfg["family"])
    driver = importlib.import_module("benchmark.drivers." + traffic["driver"])
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        inputs = family.Inputs(cfg, seed, device)
        reading = driver.control(inputs, family.reference(inputs, device),
                                 traffic, seed, count)
        fails = sorted(k for k, lim in traffic["limits"].items()
                       if k in reading and reading[k] > lim)
        out.append({"seed": seed, **reading, "limits": traffic["limits"],
                    "fails": fails,
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--count", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.cache_dirs()
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(args.workload, seeds, args.count, args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
