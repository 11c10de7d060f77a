"""Time one Alter on an Alpha that holds the LDBC SNB store.

An Alter (`Alpha.alter`) rebuilds the newest snapshot under the merged
schema (`MVCCStore.rebuild_base` → `mvcc._materialize(..., schema=)`),
and `Alpha.open` does the same again when it replays the Alter's WAL
record. This tool boots an Alpha from a checkpoint of the store that
`models/ldbc.generate(sf, seed)` gives, adds a term index to
`last_name`, and prints one JSON line:

    alter_s        the Alter, the WAL record's fsync included
    replay_open_s  `Alpha.open` of the same directory: checkpoint load,
                   WAL replay and the rebuild the schema record asks for
    literal_s      the same rebuild through `mvcc._materialize_literal`,
                   the reference's one-call-per-posting fold
    equal          the Alter's store equals the literal fold's and the
                   replayed one, tablet for tablet, and a query on the
                   new index answers the same on `--device` as on the
                   numpy route

Run it on the card from the repo root:

    python3 -m dgraph_tpu_torch.tools.alter_time [--sf 1.0] [--seed 9]

and `--device cpu --sf 0.02` for a rehearsal without a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time

ALTER = "last_name: string @index(exact, term) .\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.store import checkpoint, mvcc
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder, store_diff

    out: dict = {"sf": args.sf, "seed": args.seed, "device": args.device,
                 "alter": ALTER.strip()}
    if args.device != "cpu":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    g = ldbc.generate(sf=args.sf, seed=args.seed)
    b = StoreBuilder()
    ldbc.load_into(b, g)
    store = b.finalize()
    out["nodes"] = int(store.n_nodes)
    tmp = tempfile.mkdtemp(prefix="alter_time_")
    try:
        p_dir = f"{tmp}/p"
        checkpoint.save_versioned(store, p_dir, base_ts=1)

        def open_alpha():
            return Alpha.open(p_dir, device=args.device,
                              device_threshold=512)

        a = open_alpha()
        base = a.mvcc.base
        t0 = time.perf_counter()
        a.alter(ALTER)
        out["alter_s"] = time.perf_counter() - t0
        ts = a.oracle.read_only_ts()
        altered = a.mvcc.read_view(ts)
        merged = base.schema.clone()
        merged.update(parse_schema(ALTER))
        t0 = time.perf_counter()
        literal = mvcc._materialize_literal(base, [], schema=merged)
        out["literal_s"] = time.perf_counter() - t0
        diffs = [store_diff(altered, literal)]
        a.wal.close()
        t0 = time.perf_counter()
        a2 = open_alpha()
        out["replay_open_s"] = time.perf_counter() - t0
        diffs.append(store_diff(a2.mvcc.read_view(ts), altered))
        q = ('{ q(func: anyofterms(last_name, "%s")) { count(uid) } }'
             % g.last_name[0])
        got = a2.query_raw(q)
        want = Engine(altered, device="cpu",
                      device_threshold=10**9).query_bytes(q)
        if got != want:
            diffs.append(f"query on the new index: {got!r} != {want!r}")
        a2.wal.close()
        out["diffs"] = [d for d in diffs if d is not None]
        out["equal"] = not out["diffs"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    if not out["equal"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
