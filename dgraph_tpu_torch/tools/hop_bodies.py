"""Device time of each narrow hop body on one bucket, to set the rule.

    python3 -m dgraph_tpu_torch.tools.hop_bodies [--out FILE]

`ops/bucket_hop.py:choose_body` sends a bucket of narrow rows (fewer
than 32 vector words: every serving batch) to a thread per (row, word),
a warp per row or a block per row split over parts. This tool builds a
one-entry launch table for each of those bodies, forced, on random
buckets at W in 1, 2, 3, 4, 8, 32 words, K from 2 to 131,072 slots and
4 to 65,536 rows (at most 2^24 slots), over a 2^20-row frontier with 1 %
and 20 % of its rows occupied, and reads each launch's device time from
torch.profiler (median of REPS launches; a launch of a few microseconds
is shorter than its host call, so CUDA events would time the host).
Every body's result is held bit-exact against `bucket_hop_plain` on the
same bucket first. Needs one CUDA card; prints one JSON object per
bucket (the bodies' times, the fastest, and the rule's pick over the
fastest) and a summary line, and writes them all to --out when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

ROWS = 1 << 20
WIDTHS = (1, 2, 3, 4, 8, 32)
KS = (2, 4, 8, 16, 32, 64, 128, 256, 1024, 2048, 4096, 16384, 131072)
N_BS = (4, 64, 4096, 65536)
MAX_SLOTS = 1 << 24
OCCUPANCY = (0.01, 0.2)
PART_SLOTS = (512, 1024, 2048, 4096, 8192)
REPS = 9


def bodies(n_b: int, K: int, wv: int) -> dict:
    """name -> (body, lg, parts) for every narrow body at (K, wv), a row
    split over blocks of each of PART_SLOTS, and `rule`: what
    choose_body picks."""
    from dgraph_tpu_torch.ops import bucket_hop as bh
    lg = (wv - 1).bit_length()
    out = {"narrow": (bh.NARROW, lg, 1),
           "narrow_warp": (bh.NARROW_WARP, lg, 1),
           "narrow_block": (bh.NARROW_BLOCK, lg, 1)}
    for ps in PART_SLOTS:
        parts = -(-K // ps)
        if parts > 1:
            out[f"narrow_block/{ps}"] = (bh.NARROW_BLOCK, lg, parts)
    out["rule"] = bh.choose_body(n_b, K, wv)
    return out


def launch_us(runs, tries: int = 5) -> list:
    """Device µs of REPS launches of each of `runs` in turn, from one
    profile (taken again when the profiler drops a launch's event)."""
    from dgraph_tpu_torch.tools.hop_profile import device_events

    def all_runs():
        for run in runs:
            for _ in range(REPS):
                run()

    for _ in range(tries):
        us = [u for name, u in device_events(all_runs)
              if "bucket_hop" in name]
        if len(us) == REPS * len(runs):
            return us
    raise AssertionError(f"the profiler kept {len(us)} of "
                         f"{REPS * len(runs)} launches {tries} times over")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("hop_bodies: needs a CUDA card")
    from dgraph_tpu_torch.ops import bucket_hop as bh
    from dgraph_tpu_torch.ops.bfs import row_flags

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    records = []
    for W in WIDTHS:
        vec4 = W % 4 == 0
        wv = bh.row_words(W, vec4)
        for occ in OCCUPANCY:
            fr = torch.randint(-2**31, 2**31, (ROWS + 1, W), generator=gen,
                               dtype=torch.int64, device=dev).to(torch.int32)
            fr[torch.rand(ROWS + 1, generator=gen, device=dev) >= occ] = 0
            fr[ROWS] = 0
            flags = row_flags(fr)
            cases = []
            for K in KS:
                for n_b in N_BS:
                    if n_b * K > MAX_SLOTS:
                        continue
                    nbr = torch.randint(0, ROWS + 1, (n_b, K), generator=gen,
                                        dtype=torch.int64,
                                        device=dev).to(torch.int32)
                    out = torch.empty((n_b, W), dtype=torch.int32, device=dev)
                    want = bh.bucket_hop_plain(nbr, fr, flags=flags)
                    tabs = {}
                    for name, choice in bodies(n_b, K, wv).items():
                        tabs[name] = bh.build_table(
                            [[(nbr, n_b, 0, bh.OUT)]], W, vec4, dev,
                            out_rows=n_b,
                            rule=lambda _n, _k, _w, c=choice: c)
                        out.fill_(-1)
                        bh.run_table(tabs[name], fr, out, flags=flags)
                        torch.cuda.synchronize()
                        if not torch.equal(out, want):
                            raise AssertionError(
                                f"{name} != plain at W={W} K={K} n_b={n_b}")
                    cases.append((K, n_b, nbr, out, tabs))
                    del want

            for K, n_b, _nbr, out, tabs in cases:
                us = launch_us([lambda tab=tab: bh.run_table(
                    tab, fr, out, flags=flags) for tab in tabs.values()])
                ms = {name: float(np.median(us[i * REPS:(i + 1) * REPS]))
                      / 1e3 for i, name in enumerate(tabs)}
                rule = bh.choose_body(n_b, K, wv)
                rec = {"W": W, "occupancy": occ, "K": K, "n_b": n_b,
                       "ms": ms, "fastest": min(ms, key=ms.get),
                       "rule": [bh.BODIES[rule[0]], rule[2]],
                       "rule_over_fastest": ms["rule"] / min(ms.values())}
                records.append(rec)
                print(json.dumps(rec), flush=True)
            del cases
            del fr, flags
    ratios = [r["rule_over_fastest"] for r in records]
    summary = {"device": smi, "cases": len(records),
               "rule_over_fastest_median": float(np.median(ratios)),
               "rule_over_fastest_max": max(ratios),
               "rule_within_1_25": sum(x <= 1.25 for x in ratios)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "records": records}, f, indent=1)


if __name__ == "__main__":
    main()
