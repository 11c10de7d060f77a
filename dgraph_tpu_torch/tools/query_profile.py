"""Host profile of per-query serving: where one template's calls spend
their host time.

    python3 -m dgraph_tpu_torch.tools.query_profile [--sf 1.0]
        [--templates IC4,IC12] [--reps 3] [--device cuda] [--top 12]

Builds the LDBC SNB store (`models/ldbc.generate(sf, seed=9)` through the
port's StoreBuilder), warms each named template (IC1-IC14, config3) on an
`Engine` at device_threshold 512, then prints, per template and with
whole-block programs (`engine/fused.py`) on and off, the mean host
milliseconds of `reps` calls of `query_bytes` and the functions with the
largest cumulative time under `cProfile` over the same calls.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import time

from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.models import ldbc
from dgraph_tpu_torch.store.store import StoreBuilder


def _top(prof: cProfile.Profile, n: int) -> list:
    st = pstats.Stats(prof)
    rows = []
    for (path, line, fn), (_cc, calls, _tt, cum, _c) in st.stats.items():
        rows.append((cum, f"{os.path.basename(path)}:{line}({fn})", calls))
    rows.sort(reverse=True)
    return [{"fn": name, "calls": calls, "cum_ms": 1e3 * cum}
            for cum, name, calls in rows[:n]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--templates", default="IC4,IC12,IC3")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    g = ldbc.generate(sf=args.sf, seed=9)
    b = StoreBuilder()
    ldbc.load_into(b, g)
    store = b.finalize()
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    eng = Engine(store, device=args.device)
    was = os.environ.get("DGRAPH_TPU_FUSED")
    try:
        for name in args.templates.split(","):
            q = queries[name]
            for arm in ("1", "0"):
                os.environ["DGRAPH_TPU_FUSED"] = arm
                for _ in range(2):
                    eng.query_bytes(q)         # warm: caps, captures
                prof = cProfile.Profile()
                t0 = time.perf_counter()
                prof.enable()
                for _ in range(args.reps):
                    eng.query_bytes(q)
                prof.disable()
                ms = (time.perf_counter() - t0) * 1e3 / args.reps
                print(json.dumps({"template": name, "fused": arm == "1",
                                  "mean_ms": ms,
                                  "top": _top(prof, args.top)}),
                      flush=True)
    finally:
        if was is None:
            os.environ.pop("DGRAPH_TPU_FUSED", None)
        else:
            os.environ["DGRAPH_TPU_FUSED"] = was


if __name__ == "__main__":
    main()
