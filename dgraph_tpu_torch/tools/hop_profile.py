"""Per-bucket device times of the bench graph's four ELL hops.

    python3 -m dgraph_tpu_torch.tools.hop_profile [--out FILE]

Builds the bench workload (`powerlaw_rel(2^20, 16.0, seed=42)`, 4096
lanes seeded as bench.py's `make_seeds(2^20, 4096, seed=7)`), runs the
depth-4 `make_ell_recurse` once with `keep_hops` to get each hop's
frontier, then profiles the unfused hop `_ell_hop(prepared, frontier)`
of each with torch.profiler, twice: as the hop runs (each level of its
launch table one grouped launch: `levels_us`), and with every bucket of
the table launched alone as a one-entry table (`hop=one_bucket`, one
device event per bucket: `launches`, beside the bucket and the body the
table gave it). It also prints each hop's median time by CUDA events
and its frontier's row occupancy.

It calls `_ell_hop(prepared, frontier)` and, where the port has launch
tables, `_ell_hop(..., hop=one_bucket)`; on a revision before them it
reads the per-bucket launches from the plain hop. Put it beside an older
checkout's package to read that revision's times. Needs one CUDA card;
writes one JSON object per hop to stdout (and all of them to --out when
given).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

N_NODES = 1 << 20
AVG_DEG = 16.0
GRAPH_SEED = 42
LANES = 4096
DEPTH = 4
SEEDS_PER_QUERY = 4
REPS = 5


def make_seeds(n, B, seed=7):
    """bench.py's seed draw: SEEDS_PER_QUERY random ranks per query."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, SEEDS_PER_QUERY) for _ in range(B)]


def launch_plan(prep) -> list:
    """(what, K, rows) per bucket of one hop, in the launch table's
    order (the order `hop=one_bucket` launches them in)."""
    if "levels" not in prep:
        # before launch tables: one launch per bucket in block order
        plan = [("dense", int(e.shape[1]), rows)
                for kind, e, rows, _r0 in prep["parts"] if kind == "hop"]
        if prep["tiles"] is not None:
            t = prep["tiles"]
            plan.append(("tiles", int(t.shape[1]), int(t.shape[0])))
            plan += [("lvl2", int(t2.shape[1]), int(t2.shape[0]))
                     for t2, _r0 in prep["lvl2"]]
        return plan
    from dgraph_tpu_torch.ops.bucket_hop import PARTIALS
    plan = []
    for li, level in enumerate(prep["levels"]):
        for e, rows, _r0, dst in level:
            if e is None:
                continue
            what = "lvl2" if li else ("tiles" if dst == PARTIALS
                                      else "dense")
            plan.append((what, int(e.shape[1]), int(rows)))
    return plan


def bodies(prep, frontier) -> list:
    """The body the launch table gives each bucket of `launch_plan`, at
    this frontier's width (None before launch tables)."""
    if "levels" not in prep:
        return [None] * len(launch_plan(prep))
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import BODIES, F, ZERO
    tab = bfs.hop_table(prep, frontier, frontier)
    return [BODIES[int(r[F["body"]])] for level in tab.levels
            for r in level.rows if r[F["body"]] != ZERO]


def one_bucket(nbr, frontier, out=None, row0=0, **kw):
    """`bucket_hop` as a hop of its own: walked by `_ell_hop(...,
    hop=one_bucket)`, every bucket is one launch of a one-entry table."""
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop
    return bucket_hop(nbr, frontier, out, row0, **kw)


def device_events(run) -> list:
    """[(kernel name, device us)] of every device event of run(), in
    start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    evs.sort(key=lambda ev: ev.time_range.start)
    return [(ev.name, ev.time_range.elapsed_us()) for ev in evs]


def hop_ms(run, reps=REPS) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("hop_profile: needs a CUDA card")
    from dgraph_tpu_torch.models.synthetic import powerlaw_rel
    from dgraph_tpu_torch.ops import bfs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rel = powerlaw_rel(N_NODES, AVG_DEG, seed=GRAPH_SEED)
    g = bfs.build_ell(rel.indptr, rel.indices)
    dev = bfs.device_ell(g, "cuda")
    prep = bfs.prepare_parts(dev)
    mask0 = bfs.pack_seed_masks(g, make_seeds(N_NODES, LANES))
    W = mask0.shape[1]
    fn = bfs.make_ell_recurse(dev, g.outdeg, g.n, W, count_edges=False)
    _last, _seen, _e, hops = fn(bfs.put_mask(mask0, "cuda"), DEPTH, True)
    frontiers = [bfs.put_mask(mask0, "cuda")] + [hops[h]
                                                  for h in range(DEPTH - 1)]
    plan = launch_plan(prep)
    grouped = "levels" in prep
    records = []
    for h, fr in enumerate(frontiers, start=1):
        run = lambda: bfs._ell_hop(prep, fr)          # noqa: E731
        run()                                          # warm-up
        ms = hop_ms(run)
        evs = device_events(run)
        level_us = [us for name, us in evs if "bucket_hop" in name]
        if grouped:
            each = lambda: bfs._ell_hop(prep, fr, hop=one_bucket)  # noqa
            each()
            hop_evs = [us for name, us in device_events(each)
                       if "bucket_hop" in name]
        else:
            hop_evs = level_us
        rec = {
            "hop": h, "device": smi, "lanes": LANES,
            "occupied_rows": int(fr[:g.n].any(1).sum()),
            "rows": g.n, "ms": ms, "median_ms": float(np.median(ms)),
            "device_us": sum(us for _n, us in evs),
            "bucket_hop_us": sum(level_us),
            "levels_us": level_us if grouped else None,
            "launches": [[what, K, rows, body, us] for (what, K, rows), body,
                         us in zip(plan, bodies(prep, fr), hop_evs)],
            "other_events": [[name[:60], us] for name, us in evs
                             if "bucket_hop" not in name],
        }
        if len(hop_evs) != len(plan):
            rec["unmatched_launch_events"] = len(hop_evs)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
