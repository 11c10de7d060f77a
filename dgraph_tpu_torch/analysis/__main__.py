"""CLI: `python -m dgraph_tpu_torch.analysis [--format=text|json] [paths...]`.

Exit status 0 = no unwaived findings, 1 = findings (the build-failing
condition `tests/test_torch_lint.py` enforces), 2 = usage error.
Default scan set: the whole dgraph_tpu_torch package + chip_smoke.py.

Second mode, the bench regression gate:
`--bench-compare OLD.json NEW.json [--bench-threshold 0.10]` diffs the
shared quality keys of two BENCH JSON documents (edges/s, latency
percentiles, kernel launches, shed precision) and exits 1 when any
drifts past the threshold in its bad direction. See compare.py.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from dgraph_tpu_torch.analysis import Analyzer, default_paths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dgraph_tpu_torch.analysis",
        description="graftlint: AST invariant checker (rules R1-R15, "
                    "incl. the graftrace lock-discipline rules)")
    ap.add_argument("paths", nargs="*", type=pathlib.Path,
                    help="files/dirs to scan (default: the package "
                         "+ chip_smoke.py)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--show-waived", action="store_true",
                    help="text mode: also print waived findings")
    ap.add_argument("--facts", action="store_true",
                    help="text mode: print the facts inventory totals")
    ap.add_argument("--bench-compare", nargs=2,
                    metavar=("OLD.json", "NEW.json"),
                    help="bench regression gate: diff two BENCH JSON "
                         "files' shared quality keys; exit 1 past the "
                         "threshold (skips the lint scan)")
    ap.add_argument("--bench-threshold", type=float, default=0.10,
                    help="fractional drift in a key's bad direction "
                         "that fails the gate (default 0.10)")
    args = ap.parse_args(argv)

    if args.bench_compare:
        from dgraph_tpu_torch.analysis.compare import bench_compare_main
        return bench_compare_main(args.bench_compare[0],
                                  args.bench_compare[1],
                                  args.bench_threshold, args.format)

    repo_root = pathlib.Path(__file__).resolve().parents[2]
    paths = args.paths or default_paths(repo_root)
    a = Analyzer(repo_root=repo_root)
    a.run(paths)

    if args.format == "json":
        print(json.dumps(a.to_json(), indent=2))
    else:
        for f in a.findings:
            if f.waived and not args.show_waived:
                continue
            print(f.format())
        counts = a.counts()
        print(f"graftlint: {len(a.unwaived())} finding(s), "
              f"{sum(counts['waived'].values())} waived, "
              f"{len(a.contexts)} file(s) scanned")
        if args.facts:
            print("facts:", json.dumps(a.facts["totals"]))
    return 1 if a.unwaived() else 0


if __name__ == "__main__":
    sys.exit(main())
