"""Drive the PyTorch port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises and exits non-zero:

  1. device   — needs torch.cuda; prints `nvidia-smi` name and power limit
  2. build    — compiles every CUDA kernel of the path from csrc/ (nvcc,
                all sources at once), then the native host library
                (native/*.cpp, g++)
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bit-exact:
                - random buckets: K in 1,3,8,32,1024; W in 1,2,3,8,128,256;
                  frontier row occupancy 1 %, 20 %, 100 %; exact and
                  all-ones row flags; plain and fused (first-visit) mode;
                  out, seen and flags compared, rows outside the bucket's
                  slice untouched;
                - the four real hops of the phase-5 run, each from the
                  frontier and seen of the run up to the hop before: fused
                  kernel vs plain fused hop and vs the unfused kernel plus
                  the torch update; per hop its time, row occupancy and
                  least-bytes bound; per-launch times of hops 1 and 4;
                - the first kernel's yardstick: one unfused, flag-less hop
                  of a random ~0.25-density frontier (every row occupied),
                  beside that kernel's 2.672 ms (PERF.md)
  4. serve    — a 2^20-node / 16.5M-edge store (powerlaw_edges seed 42,
                `follows` uid edges, `name: string @index(exact)` "p<i>");
                a batch of eq(name) @recurse queries through
                engine.batch.query_batch on the card, byte-equal to the same
                batch served with device="cpu"; launch counts are zeroed
                just before this run and read just after
  5. bench    — bench.py stage 2 on the card: 4096 lanes (W = 128 int32
                words), depth 4, seeds make_seeds(2^20, 4096, seed=7);
                make_ell_recurse(count_edges=False) timed with CUDA events
                (median of 5, seed mask re-put outside the timed region),
                then make_ell_count; per-lane counts checked against the
                numpy walk for 64 lanes and the total against its
                978,649,539; the profile must show no torch bitwise
                kernel (the first-visit update runs inside the hop
                launches); bound_ms is the sum of phase 3's per-hop bounds
  6. ldbc     — per-query serving (engine.Engine) over LDBC SNB SF1
                (models/ldbc.generate(sf=1.0, seed=9) + load_into the port's
                StoreBuilder; generation and build seconds printed): the 14
                IC templates and the config-3 query through
                Engine(device="cuda") at device_threshold 512 and at 0
                (every non-empty frontier on the card), each response
                byte-equal to Engine(device="cpu", device_threshold=10**9),
                the pure numpy route (whole-block programs off); the card
                route (programs on) must serve at least one expansion of
                config 3 and of the IC mix at 512. Prints the
                per-route counts, the warm p50 of each template (3 reps) on
                all three routes and the IC mix's p50 over all its
                requests, config 3's p50 and edges/s, and a
                torch.profiler breakdown of one mix pass at 512: device and
                wall time, top kernels, per template its wall and device
                time, and per engine layer (parse, execute, render) and op
                (gather_edges, expand_level, to_device, to_host) its calls,
                device launches, host and device time, with each compute
                op's least-bytes bound; and gather_edges' edge→row map
                timed two ways at real `knows` frontiers (the reference's
                scatter + cummax, the port's search), equal maps asserted
  7. ic batch — lane-kernel serving of the LDBC IC mix on the SF1 store of
                phase 6: 32 instances of each of IC1-IC13 and config 3 and
                4 of IC14 (models/ldbc.ic_batch, a distinct start person
                per instance) in one engine.batch.query_batch call on the
                card. (a) every group formed as planned (IC1-IC12 and
                config 3 level trees, IC13 a shortest group, IC14 left to
                the per-query engine), the bucket_hop launches under the
                call (counts zeroed just before, read just after), each
                response equal (sort_keys JSON) to Engine(device="cuda")
                on the same query, cold and warm batch wall time against
                the per-query engine's over the same queries, a profile
                of the warm batch by range (tree / step / recurse runs
                against their host rebuild and render), and every tree
                and step program of the batch held against the same
                program on bucket_hop_plain, mask for mask; (b) at 1024
                lanes (W = 32): the tree programs of IC3, IC12 and config
                3 and one 8-hop make_ell_step stage, first-visit and
                level-DAG, each against its plain-hop run, with its
                launches, CUDA-event time (median of 5), plain time and
                least-bytes bound
  8. dql features — the DQL-feature mix (tools/feature_mix.py) on a second
                store built from phase 6's SF1 graph (phase 7's store freed
                first): models/ldbc.SCHEMA plus first_name with trigram and
                fulltext indexes, one geo point per person and 16 password
                hashes. (a) the 13 templates (aggregates, math, @groupby at
                the root and per parent, @cascade, @normalize, regexp,
                match, anyoftext, near, within, checkpwd) through
                Engine(device="cuda") at device_threshold 512, each
                byte-equal to Engine(device="cpu", device_threshold=10**9);
                per template its cold time, the p50 of 3 warm requests, its
                route counts and its device time from one profiled pass;
                (b) one query_batch of 8 instances of each (104 queries, a
                distinct start person per uid template) on the card: the
                families formed (agg_minmax and math must be tree groups),
                the bucket_hop launches under the call (counts zeroed just
                before, read just after, at least one), cold and warm
                wall, and every response equal (sort_keys JSON) to
                Engine(device="cuda") on the same query; then one profiled
                warm batch: host and device time of the tree groups' run
                and rebuild and of the left-over queries, each beside the
                per-query engine's time for the same queries
  9. fused    — whole-block programs (engine/fused.py) and the native
                emitter on phase 6's SF1 store, run after phase 7 while
                that store lives: the 14 IC templates and config 3
                through Engine(device="cuda") at 512, each byte-equal to
                the numpy route; per template the fused blocks and their
                stage kinds, caps, captures and capture ms, cold ms, p50
                with programs on and off (requests interleaved), the
                render alone with the native emitter and the dict
                renderer, and for every captured program one replay
                bit-equal to an eager run of its plain function, its
                replay ms and the eager run's (CUDA events, median of 5)
                beside its least-bytes bound and its launches per replay
                (the plain function's, profiled), with profiled launches
                per template on and off, and ops/recurse.masked_hop alone
                at config 3's first hop. Fails on any fallback, a fused
                count below the eligible blocks, graphs holding more than
                fused.PROGRAM_BYTES or the phase leaving more than that
                reserved on the card, or an emitter that did not build or
                serve. Then the SF1 store built again with
                the numpy CSR builder (equal CSR, both build times) and
                the CSR builders alone on the store's shuffled pairs
  10. graphrag — GraphRAG retrieval and @msgpass (tools/graphrag_mix.py)
                on ONE SF1 store shared with phase 8 (built after phase 9:
                feature_mix's extension plus a 384-d `emb` per person and
                message, 1,009,892 rows, small integers from a seed).
                (a) segment_combine against segment_combine_plain on the
                card (integer features) and against numpy's host_combine
                (N(0,1) features, and a second kernel run), bit for bit:
                d in 1, 3, 8, 128, 384, each agg, sorted and unsorted
                seg, duplicates, non-participating neighbours, empty
                segments, a sentinel-padded tail, and 120,000-edge hubs;
                (b) the nine templates through Engine(device="cuda") at
                512, each byte-equal to the numpy route, planned as
                expected (knn → hop, knn → recurse, recurse → featprop,
                knn → recurse → featprop, staged @msgpass), with route
                counts, cold ms and the p50 of 3 warm requests, and every
                captured program held against an eager run of its plain
                function; (c) one query_batch of 32 knn_hop, 32
                knn_recurse and 8 of each featprop template: knn_recurse
                a recurse group, knn_hop a tree group, @msgpass per
                query, every response equal to Engine(device="cuda"); the
                bucket_hop and segment_combine launches of (b) and (c),
                counted from zero; (d) the device top-k and
                segment_combine alone at msgpass_hub's and featprop_mean's
                shapes (CUDA events, median of 5) beside their least-bytes
                bounds, plain versions and, for segment_combine,
                `index_add_` of the gathered rows
  11. the `kernels` JSON line, then the device JSON line last

Phases 6 to 10 fail if any block falls back from its whole-block program
to the staged route.

It imports torch, numpy and dgraph_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_NODES = 1 << 20
AVG_DEG = 16.0
GRAPH_SEED = 42
SERVE_QUERIES = 32
SERVE_DEPTH = 3
LANES = 4096
DEPTH = 4
REPS = 5
CHECK_LANES = 64
BENCH_TOTAL_EDGES = 978_649_539    # the numpy walk over all 4096 lanes
# the first CUDA kernel's unfused full hop on this card (PERF.md)
FIRST_KERNEL_HOP_MS = 2.672
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak (NVIDIA data sheet)
# no int32 ALU peak is published; the float32 non-tensor peak (67 T/s,
# same data sheet) stands in for the bitwise-OR rate
ALU_OPS_PER_S = 67e12
LDBC_SF = 1.0
LDBC_SEED = 9
LDBC_REPS = 3
LDBC_THRESHOLD = 512
HOST_ONLY = 10**9                  # device_threshold of the pure numpy route
# the executor's profiler ranges, one per device op of the per-query path
LDBC_OPS = ("hop.gather_edges", "level.expand_level", "engine.to_device",
            "engine.to_host")
# the engine's host layers, one profiler range each
LDBC_LAYERS = ("engine.parse", "engine.execute", "engine.render")
# phase 7: the mixed IC batch and the 1024-lane kernel-only programs
IC_BATCH_COPIES = 32
IC14_COPIES = 4
IC_BATCH_SEED = 5
KERNEL_LANES = 1024
KERNEL_TEMPLATES = ("IC3", "IC12", "config3")
STEP_HOPS = 8
# the lane serving path's profiler ranges (engine/batch.py, treebatch.py)
BATCH_RANGES = ("batch.tree_run", "batch.tree_rebuild", "batch.step_run",
                "batch.shortest_rebuild", "batch.recurse_run",
                "batch.recurse_rebuild", "batch.leftover")
# phase 8: the DQL-feature mix
FEATURE_COPIES = 8
FEATURE_REPS = 3
# phase 9: whole-block programs and the native emitter
FUSED_REPS = 3        # interleaved fused-on / fused-off requests per template
REPLAY_REPS = 5       # CUDA-event replays per captured program
CSR_SEED = 3          # shuffle of the SF1 edge pairs fed to the CSR builders
KERNEL_SOURCES = {"bucket_hop": "dgraph_tpu_torch/csrc/bucket_hop.cu",
                  "segment_combine":
                      "dgraph_tpu_torch/csrc/segment_combine.cu"}
KERNEL_REPLACES = {"bucket_hop": "dgraph_tpu/ops/pallas_hop.py:108",
                   "segment_combine": "dgraph_tpu/ops/feat.py:41"}
GRAPHRAG_REPS = 3       # warm requests per GraphRAG template
GRAPHRAG_KNN_COPIES = 32
GRAPHRAG_FEAT_COPIES = 8
COMBINE_SEED = 13       # the random segment_combine cases
COMBINE_DIMS = (1, 3, 8, 128, 384)
COMBINE_EDGES = 8000
HUB_EDGES = 120_000


def say(phase: str, **kv) -> None:
    print(f"{phase}: " + json.dumps(kv, default=str), flush=True)


@contextlib.contextmanager
def fusion(on: bool):
    """Whole-block programs (engine/fused.py) on or off inside the block:
    the DGRAPH_TPU_FUSED switch, read per query."""
    was = os.environ.get("DGRAPH_TPU_FUSED")
    os.environ["DGRAPH_TPU_FUSED"] = "1" if on else "0"
    try:
        yield
    finally:
        if was is None:
            del os.environ["DGRAPH_TPU_FUSED"]
        else:
            os.environ["DGRAPH_TPU_FUSED"] = was


@contextlib.contextmanager
def no_fused_fallback(phase: str):
    """Fail `phase` if a block fell back from its whole-block program to
    the staged route inside it (on the card a failing program raises, so
    this holds the route to that)."""
    from dgraph_tpu_torch.engine import fused

    def seen():
        st = fused.status()
        return st["fallbacks"], st["routes"]["fallback"], len(st["disabled"])

    before = seen()
    yield
    if seen() != before:
        raise AssertionError(f"{phase}: whole-block program fallbacks "
                             f"{before} -> {seen()}")


def cpu_recurse(indptr, indices, seeds, depth):
    """bench.py's numpy loop=false walk for ONE query → edges traversed."""
    frontier = np.unique(seeds).astype(np.int64)
    seen_mask = np.zeros(indptr.shape[0] - 1, bool)
    seen_mask[frontier] = True
    edges = 0
    for _ in range(depth):
        if not len(frontier):
            break
        starts = indptr[frontier].astype(np.int64)
        deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        total = int(deg.sum())
        base = np.repeat(np.cumsum(deg) - deg, deg)
        pos = np.repeat(starts, deg) + (np.arange(total) - base)
        nbrs = indices[pos]
        edges += total
        nxt = np.unique(nbrs)
        nxt = nxt[~seen_mask[nxt]]
        seen_mask[nxt] = True
        frontier = nxt
    return edges


def cuda_ms(fn, reps: int, setup=None) -> list:
    """Per-rep device milliseconds of fn() by CUDA events; setup() runs
    before each rep outside the timed region."""
    out = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(arg)
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def random_frontier(rows: int, W: int, gen, device, density=0.5):
    """[rows + 1, W] int32 lane words with ~density bits set and an
    all-zero sentinel row last."""
    words = torch.randint(-2**31, 2**31, (rows + 1, W), dtype=torch.int64,
                          generator=gen, device=device).to(torch.int32)
    if density < 0.5:
        keep = torch.randint(-2**31, 2**31, (rows + 1, W),
                             dtype=torch.int64, generator=gen,
                             device=device).to(torch.int32)
        words &= keep
    words[rows] = 0
    return words


# -- phases -------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script measures the port on a GPU and has nothing to run",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("phase 1 device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def phase_build() -> dict:
    from dgraph_tpu_torch.utils import kbuild
    t0 = time.perf_counter()
    report = kbuild.build_all()
    cuda_s = time.perf_counter() - t0
    from dgraph_tpu_torch import native
    t0 = time.perf_counter()
    native.load()
    say("phase 2 build", seconds=round(cuda_s, 3),
        built={k: {"seconds": round(v["seconds"], 3), "ptxas": v["ptxas"]}
               for k, v in report.items()},
        native={"library": os.path.relpath(native.lib_path()),
                "seconds": round(time.perf_counter() - t0, 3)})
    return report


RANDOM_WIDTHS = (1, 2, 3, 8, 128, 256)
RANDOM_KS = (1, 3, 8, 32, 1024)
RANDOM_OCCUPANCY = (0.01, 0.2, 1.0)


def phase_random_buckets(device) -> dict:
    """bucket_hop vs bucket_hop_plain on random buckets, bit-exact: every
    W x K x row count x frontier row occupancy, with exact and all-ones
    flags, plain and fused mode; out, seen and both flag arrays compared
    whole, and the rows outside the bucket's slice checked untouched."""
    from dgraph_tpu_torch.ops.bfs import row_flags
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop, bucket_hop_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    cases = 0
    rows = 100_003
    for W in RANDOM_WIDTHS:
        for occ in RANDOM_OCCUPANCY:
            fr = random_frontier(rows, W, gen, device)
            fr[torch.rand(rows + 1, generator=gen, device=device) >= occ] = 0
            fr[rows] = 0
            exact = row_flags(fr)
            for flags in (exact, torch.ones_like(exact)):
                for K in RANDOM_KS:
                    for n_b in ((1, 37, 3001) if K < 1024 else (1, 517, 1500)):
                        nbr = torch.randint(0, rows + 1, (n_b, K),
                                            generator=gen, dtype=torch.int64,
                                            device=device).to(torch.int32)
                        nbr[:, -1] = rows      # every row touches the sentinel
                        seen0 = random_frontier(n_b + 2, W, gen, device,
                                                density=0.25)
                        seen0[torch.rand(n_b + 3, generator=gen,
                                         device=device) < 0.5] = 0
                        for fused in (False, True):
                            got, want = [], []
                            for hop, res in ((bucket_hop, got),
                                             (bucket_hop_plain, want)):
                                out = torch.full((n_b + 3, W), -1,
                                                 dtype=torch.int32,
                                                 device=device)
                                of = torch.full((n_b + 3,), 7,
                                                dtype=torch.uint8,
                                                device=device)
                                seen = seen0.clone()
                                hop(nbr, fr, out, 2, flags=flags,
                                    out_flags=of,
                                    seen=seen if fused else None)
                                res += [out, of, seen]
                            torch.cuda.synchronize()
                            out, of, seen = got
                            ok = (all(torch.equal(a, b)
                                      for a, b in zip(got, want))
                                  and bool((out[:2] == -1).all())
                                  and bool((out[2 + n_b:] == -1).all())
                                  and bool((of[:2] == 7).all())
                                  and bool((of[2 + n_b:] == 7).all())
                                  and torch.equal(seen[:2], seen0[:2])
                                  and torch.equal(seen[2 + n_b:],
                                                  seen0[2 + n_b:]))
                            if not fused:
                                ok = ok and torch.equal(seen, seen0)
                            if not ok:
                                raise AssertionError(
                                    f"bucket_hop != plain at W={W} K={K} "
                                    f"n_b={n_b} occupancy={occ} fused={fused} "
                                    f"exact_flags={flags is exact}: out err "
                                    f"{max_abs_err(got[0], want[0])}")
                            cases += 1
    empty = torch.zeros((0, 4), dtype=torch.int32, device=device)
    bucket_hop(empty, random_frontier(10, 4, gen, device))
    return {"cases": cases, "max_abs_err": 0}


def hop_bound(g, W: int, occupied_rows: int, nxt_rows: int,
              fresh_rows: int, occupied_slots: int) -> dict:
    """The least time one fused hop could take on this run's data: every
    index once (level 1 and 2), each occupied frontier row once, the
    frontier's and the result's flags, seen read where the hop's OR has
    bits, the fresh mask written whole, seen written where fresh has
    bits — over the HBM rate; the ORs (one per occupied slot and lane
    word) over the ALU rate. The larger of the two."""
    row = 4 * W
    idx_bytes = 4 * (g.padded_edges + sum(int(t.size) for t in g.lvl2))
    nbytes = (idx_bytes + occupied_rows * row + 2 * (g.n + 1)
              + nxt_rows * row + (g.n + 1) * row + fresh_rows * row)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = occupied_slots * W / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes": nbytes,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def per_launch(prep, run, tries: int = 3):
    """[what, K, rows, kernel, us] per bucket_hop launch of run(), or
    None when the profiler's trace misses launches `tries` times over
    (its device events come back asynchronously and can be dropped)."""
    from dgraph_tpu_torch.tools.hop_profile import device_events, launch_plan

    plan = launch_plan(prep)
    for _ in range(tries):
        hops = [(name, us) for name, us in device_events(run)
                if "bucket_hop" in name]
        if len(hops) == len(plan):
            return [[what, K, rows,
                     next(v for v in ("split", "warp", "narrow")
                          if v in name), round(us, 3)]
                    for (what, K, rows), (name, us) in zip(plan, hops)]
    return None


def phase_bench_hops(g, device, mask0: np.ndarray) -> dict:
    """The four real hops of the bench run (4096 lanes, depth 4), each
    from the frontier, flags and seen of the run up to the hop before:
    the fused kernel hop bit-exact against the plain fused hop (fresh,
    seen, flags) and against the unfused kernel hop; each hop's time,
    occupancy and least-bytes bound; per-launch times of hops 1 and 4."""
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain

    prep = bfs.prepare_parts(bfs.device_ell(g, device))
    W = mask0.shape[1]
    n = g.n
    seen = bfs.put_mask(mask0, device)
    frontier = seen.clone()
    flags = bfs.row_flags(frontier)
    level1 = [e for kind, e, _rows, _r0 in prep["parts"] if kind == "hop"]
    if prep["tiles"] is not None:
        level1.append(prep["tiles"])
    hops = []
    for h in range(1, DEPTH + 1):
        res = {}
        for name, hop in (("kernel", None), ("plain", bucket_hop_plain)):
            s = seen.clone()
            fl = torch.empty(n + 1, dtype=torch.uint8, device=device)
            kw = {} if hop is None else {"hop": hop}
            res[name] = (bfs._ell_hop(prep, frontier, flags=flags, seen=s,
                                      out_flags=fl, **kw), s, fl)
        nxt_flags = torch.empty(n + 1, dtype=torch.uint8, device=device)
        nxt = bfs._ell_hop(prep, frontier, flags=flags, out_flags=nxt_flags)
        torch.cuda.synchronize()
        fresh, s_new, fl_new = res["kernel"]
        if not all(torch.equal(a, b) for a, b in zip(res["kernel"],
                                                     res["plain"])):
            raise AssertionError(f"bench hop {h}: fused kernel != plain, "
                                 f"err {max_abs_err(fresh, res['plain'][0])}")
        if (not torch.equal(fresh, nxt & ~seen)
                or not torch.equal(s_new, seen | fresh)
                or not torch.equal(nxt_flags, bfs.row_flags(nxt))):
            raise AssertionError(f"bench hop {h}: fused kernel != unfused "
                                 f"kernel + torch update")
        fl_scratch = torch.empty(n + 1, dtype=torch.uint8, device=device)
        ms = cuda_ms(lambda s: bfs._ell_hop(prep, frontier, flags=flags,
                                            seen=s, out_flags=fl_scratch),
                     REPS, setup=seen.clone)
        plain_ms = cuda_ms(
            lambda s: bfs._ell_hop(prep, frontier, hop=bucket_hop_plain,
                                   flags=flags, seen=s,
                                   out_flags=fl_scratch),
            1, setup=seen.clone)
        occupied_rows = int(flags[:n].sum())
        occupied_slots = sum(int(flags[e.long()].sum()) for e in level1)
        bound = hop_bound(g, W, occupied_rows, int(nxt_flags.sum()),
                          int(fl_new.sum()), occupied_slots)
        rec = {"hop": h, "occupied_rows": occupied_rows,
               "row_occupancy": occupied_rows / n,
               "occupied_level1_slots": occupied_slots,
               "slot_occupancy": occupied_slots / g.padded_edges,
               "ms": ms, "median_ms": float(np.median(ms)),
               "plain_ms": plain_ms[0], **bound}
        if h in (1, DEPTH):
            s = seen.clone()
            rec["launches_us"] = per_launch(
                prep, lambda: bfs._ell_hop(prep, frontier, flags=flags,
                                           seen=s, out_flags=fl_scratch))
        hops.append(rec)
        del res, nxt
        frontier, flags, seen = fresh, fl_new, s_new
    return {"hops": hops, "prep": prep}


def phase_unfused_hop(g, device, prep) -> dict:
    """The first kernel's measurement, for comparison: one full hop
    without the epilogue or flags on a random frontier of ~0.25 bit
    density (every row occupied), kernel vs plain."""
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    W = LANES // 32
    fr = random_frontier(g.n, W, gen, device, density=0.25)
    got = bfs._ell_hop(prep, fr)
    want = bfs._ell_hop(prep, fr, hop=bucket_hop_plain)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"unfused ELL hop: kernel != plain, err {err}")
    ms = cuda_ms(lambda _: bfs._ell_hop(prep, fr), REPS)
    plain_ms = cuda_ms(lambda _: bfs._ell_hop(prep, fr,
                                              hop=bucket_hop_plain), 3)
    return {"ms": ms, "median_ms": float(np.median(ms)),
            "plain_ms": plain_ms, "first_kernel_ms": FIRST_KERNEL_HOP_MS}


def host_us_per_launch(device, calls: int = 2000) -> float:
    """Host microseconds per fused bucket_hop call on a one-row bucket at
    W = 128: the wrapper's checks, the ctypes call and the launch, which
    a hop pays 41 times on the bench graph."""
    from dgraph_tpu_torch.ops.bfs import row_flags
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop

    fr = torch.zeros((1001, 128), dtype=torch.int32, device=device)
    out, seen = torch.zeros_like(fr), torch.zeros_like(fr)
    nbr = torch.zeros((1, 1), dtype=torch.int32, device=device)
    flags = row_flags(fr)
    out_flags = torch.zeros(1001, dtype=torch.uint8, device=device)

    def call():
        bucket_hop(nbr, fr, out, 0, flags=flags, out_flags=out_flags,
                   seen=seen)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_ratio(a, b):
    """Device time of launch list a over that of b (None: not measured)."""
    if a is None or b is None:
        return None
    return sum(r[4] for r in a) / sum(r[4] for r in b)


def phase_kernels(g, device, mask0: np.ndarray) -> dict:
    """Every kernel against its plain version on the card: random
    buckets, the four bench hops, the unfused full hop. Returns the
    kernel record for the `kernels` line."""
    from dgraph_tpu_torch.tools.hop_profile import launch_plan

    rnd = phase_random_buckets(device)
    bench = phase_bench_hops(g, device, mask0)
    hops = bench["hops"]
    unfused = phase_unfused_hop(g, device, bench["prep"])
    ms = sum(r["median_ms"] for r in hops)
    bytes_ms = sum(r["bytes_ms"] for r in hops)
    ops_ms = sum(r["ops_ms"] for r in hops)
    say("phase 3 kernels", random_cases=rnd["cases"], random_max_abs_err=0,
        bench_hops=[{k: v for k, v in r.items() if k != "launches_us"}
                    for r in hops],
        hop1_over_hop4=hops[0]["median_ms"] / hops[-1]["median_ms"],
        hop1_over_hop4_device=device_ratio(hops[0]["launches_us"],
                                           hops[-1]["launches_us"]),
        launches_per_hop=len(launch_plan(bench["prep"])),
        hop1_launches_us=hops[0]["launches_us"],
        hop4_launches_us=hops[-1]["launches_us"],
        unfused_random_hop=unfused,
        host_us_per_launch=host_us_per_launch(device))
    return {"ms": ms, "plain_ms": sum(r["plain_ms"] for r in hops),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": 0}


def build_store(n_nodes: int):
    """The serving store: powerlaw `follows` edges (uid = rank + 1) and an
    exact-indexed name "p<rank>" on every node."""
    from dgraph_tpu_torch.models.synthetic import powerlaw_edges
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder

    src, dst = powerlaw_edges(n_nodes, AVG_DEG, seed=GRAPH_SEED)
    b = StoreBuilder(parse_schema(
        "name: string @index(exact) .\nfollows: [uid] ."))
    b.add_edges("follows", src + 1, dst + 1)
    for i in range(n_nodes):
        b.add_value(i + 1, "name", f"p{i}")
    return b.finalize()


def serve_queries(n_nodes: int, nq: int, depth: int) -> list:
    rng = np.random.default_rng(11)
    return ['{ q(func: eq(name, "p%d")) @recurse(depth: %d) '
            '{ name follows } }' % (i, depth)
            for i in rng.integers(0, n_nodes, nq).tolist()]


def phase_serve(store, device, n_nodes: int, nq: int, depth: int) -> dict:
    from dgraph_tpu_torch.engine.batch import query_batch
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES

    qs = serve_queries(n_nodes, nq, depth)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got = query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    again = query_batch(store, qs, device=device)
    warm_s = time.perf_counter() - t0
    prof = kernel_share(lambda: query_batch(store, qs, device=device))
    t0 = time.perf_counter()
    want = query_batch(store, qs, device="cpu")
    cpu_s = time.perf_counter() - t0
    body = json.dumps(got).encode()
    if body != json.dumps(want).encode() or json.dumps(again).encode() != body:
        raise AssertionError("GPU responses differ from the CPU run")
    if len(got) != nq or not all(r["q"] for r in got):
        raise AssertionError("a query returned no root object")
    for k, v in launches.items():
        if v < 1:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 f"serving path")
    say("phase 4 serve", queries=nq, depth=depth,
        cold_latency_s=cold_s, warm_latency_s=warm_s, cpu_latency_s=cpu_s,
        response_bytes=len(body), launches=launches, byte_equal=True,
        warm_profile=prof)
    return launches


def phase_bench(store, device, n_nodes: int, lanes: int, depth: int,
                check_lanes: int, bound_ms: float) -> dict:
    """The bench run; `bound_ms` is the sum of phase 3's per-hop bounds
    of these same four hops."""
    from dgraph_tpu_torch.engine.batch import _dev_for
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.tools.hop_profile import make_seeds

    g, dev = _dev_for(store, "follows", False, device)
    rel = store.rel("follows")
    seeds = make_seeds(n_nodes, lanes)
    mask0 = bfs.pack_seed_masks(g, seeds)
    W = mask0.shape[1]
    fn = bfs.make_ell_recurse(dev, g.outdeg, g.n, W, count_edges=False)
    count = bfs.make_ell_count(g.outdeg, g.n, device)
    out = fn(bfs.put_mask(mask0, device), depth)          # warm-up
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    holder = {}
    ms = cuda_ms(lambda m: holder.__setitem__("out", fn(m, depth)), REPS,
                 setup=lambda: bfs.put_mask(mask0, device))
    launches = {k: v // REPS for k, v in LAUNCHES.items()}
    last, seen, _ = holder["out"]
    edges = count(last, seen).cpu().numpy()
    step = max(1, lanes // check_lanes)
    check = list(range(0, lanes, step))[:check_lanes]
    want = [cpu_recurse(rel.indptr, rel.indices, seeds[q], depth)
            for q in check]
    if edges[check].tolist() != want:
        raise AssertionError("device edge counts differ from the numpy walk")
    m = bfs.put_mask(mask0, device)
    share = kernel_share(lambda: fn(m, depth))
    run_ms = float(np.median(ms))
    if share is not None:
        share["share_of_median_run"] = share["bucket_hop_us"] / 1e3 / run_ms
        if share["mask_update_us"]:
            raise AssertionError("the run launched torch bitwise kernels "
                                 "for the first-visit update")
    total = int(edges.sum())
    if lanes == LANES and depth == DEPTH and total != BENCH_TOTAL_EDGES:
        raise AssertionError(f"{total} edges, the numpy walk counts "
                             f"{BENCH_TOTAL_EDGES}")
    say("phase 5 bench", lanes=lanes, depth=depth, run_ms=ms,
        median_ms=run_ms, total_edges=total,
        edges_per_s=total / (run_ms / 1e3), bound_ms=bound_ms,
        bound_share=bound_ms / run_ms,
        padded_edges=g.padded_edges, launches_per_run=launches,
        kernel_share=share, checked_lanes=len(check))
    del out
    return {"run_ms": run_ms, "launches": launches}


def kernel_share(run):
    """Device time of one run by kernel, from torch.profiler: the
    bucket_hop kernels' microseconds, torch's bitwise kernels'
    microseconds, all kernels' microseconds, and the
    run's wall microseconds under the profiler (device busy share =
    device_us / wall_us). None when the profiler records no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    total = sum(by_name.values())
    if total <= 0:
        return None
    hop = sum(us for name, us in by_name.items() if "bucket_hop" in name)
    # torch's bitwise &, |, ~ kernels: the unfused first-visit update
    update = sum(us for name, us in by_name.items()
                 if "itwise" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"bucket_hop_us": hop, "mask_update_us": update,
            "device_us": total, "wall_us": wall_us,
            "device_busy_share": total / wall_us,
            "share_of_device_time": hop / total,
            "top_kernels_us": {name[:80]: us for name, us in top}}


def config3_edges(body: bytes) -> int:
    """Edges of a config-3 response, counted as bench_baseline.py counts
    them: every `knows` child below every root, recursively."""
    def count(node):
        kids = node.get("knows", [])
        return len(kids) + sum(count(k) for k in kids)
    return sum(count(r) for r in json.loads(body)["q"])


def lat_ms(fn, reps: int) -> list:
    """Host milliseconds of each of reps warm runs of fn() (each ends
    with its response bytes on the host)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_launches(ev) -> int:
    """Device kernels and copies launched under one profiler event."""
    return len(ev.kernels) + sum(device_launches(c) for c in ev.cpu_children)


def ldbc_profile(engine, queries: dict) -> dict | None:
    """One pass of the mix under torch.profiler, each query in a range
    of its own: device and wall time, the top kernels, per template its
    wall and device time, and per template and range (the engine's
    layers, the executor's ops) the calls, device launches, host and
    device microseconds. None when the profiler records no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for name, q in queries.items():
            with record_function("ldbc." + name):
                engine.query_bytes(q)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels: dict = {}
    for ev in events:
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    device_us = sum(kernels.values())
    if device_us <= 0:
        return None
    per: dict = {}
    for ev in events:
        if ev.device_type != DeviceType.CPU:
            continue
        if ev.name.startswith("ldbc."):
            rec = per.setdefault(ev.name[5:], {})
            rec["wall_us"] = ev.cpu_time_total
            rec["device_us"] = ev.device_time_total
            continue
        if ev.name not in LDBC_OPS + LDBC_LAYERS:
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("ldbc."):
            parent = parent.cpu_parent
        tmpl = parent.name[5:] if parent is not None else "?"
        rec = per.setdefault(tmpl, {}).setdefault(
            ev.name, {"calls": 0, "launches": 0, "host_us": 0.0,
                      "device_us": 0.0})
        rec["calls"] += 1
        rec["launches"] += device_launches(ev)
        rec["host_us"] += ev.cpu_time_total
        rec["device_us"] += ev.device_time_total
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": device_us, "wall_us": wall_us,
            "device_busy_share": device_us / wall_us,
            "top_kernels_us": {k[:80]: v for k, v in top},
            "per_template": per}


def seg_map_ab(store, frontiers: dict, device, reps: int = 20) -> dict:
    """The edge→row map of `gather_edges` two ways on the card, at real
    `knows` frontiers: the reference's scatter-max of row starts plus
    `torch.cummax`, and the port's search of the rows' inclusive ends.
    Both must give the same map; the device microseconds of each
    (CUDA events, median of `reps`)."""
    from dgraph_tpu_torch.engine.execute import _bucket
    from dgraph_tpu_torch.ops.hop import frontier_degrees
    from dgraph_tpu_torch.ops.uidalgebra import pad_to

    indptr, _indices = store.device_rel("knows", False, device)
    out = {}
    for name, ranks in frontiers.items():
        fr = pad_to(ranks, _bucket(len(ranks)), device)
        deg = frontier_degrees(indptr, fr)
        ends = torch.cumsum(deg, 0, dtype=torch.int32)
        total = deg.sum(dtype=torch.int32)
        cap = _bucket(max(int(total), 1))
        j = torch.arange(cap, dtype=torch.int32, device=fr.device)
        rows = torch.arange(fr.shape[0], dtype=torch.int32, device=fr.device)

        def by_cummax(_):
            starts = torch.where(deg > 0, ends - deg, cap).long()
            marks = torch.zeros(cap + 1, dtype=torch.int32, device=fr.device)
            marks.scatter_reduce_(0, starts.clamp_(max=cap), rows, "amax")
            return torch.cummax(marks[:cap], 0).values

        def by_search(_):
            seg = torch.searchsorted(ends, j, right=True)
            last = torch.searchsorted(
                ends, (total - 1).clamp(min=0).reshape(1), right=True)
            return torch.minimum(seg, torch.where(total > 0, last, 0))

        if not torch.equal(by_cummax(None), by_search(None).to(torch.int32)):
            raise AssertionError(f"edge→row maps differ at {name}")
        out[name] = {"rows": len(ranks), "edges": int(total), "slots": cap,
                     "cummax_us": 1e3 * float(np.median(cuda_ms(by_cummax,
                                                                reps))),
                     "search_us": 1e3 * float(np.median(cuda_ms(by_search,
                                                                reps)))}
    return out


def build_ldbc(sf: float = LDBC_SF) -> dict:
    """The LDBC SNB store of phases 6 and 7: the generated graph, the
    port's store, and the seconds each took."""
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.store.store import StoreBuilder

    t0 = time.perf_counter()
    g = ldbc.generate(sf=sf, seed=LDBC_SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = StoreBuilder()
    ldbc.load_into(b, g)
    return {"sf": sf, "g": g, "store": b.finalize(), "generate_s": gen_s,
            "build_s": time.perf_counter() - t0}


def phase_ldbc(device, sf: float = LDBC_SF, reps: int = LDBC_REPS,
               built: dict | None = None) -> dict:
    """Per-query serving of the LDBC IC mix and config 3 (phase 6)."""
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.models import ldbc

    built = built or build_ldbc(sf)
    g, store = built["g"], built["store"]
    sf = built["sf"]
    gen_s, build_s = built["generate_s"], built["build_s"]
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)

    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    with fusion(False):     # the pure numpy route
        want = {k: host.query_bytes(q) for k, q in queries.items()}
    routes, p50 = {}, {}
    engines = {"host": host}
    for thr in (LDBC_THRESHOLD, 0):
        eng = engines[f"card{thr}"] = Engine(store, device=device,
                                             device_threshold=thr)
        per_q = {}
        for k, q in queries.items():
            before = dict(eng.routes.expansions)
            got = eng.query_bytes(q)
            if got != want[k]:
                raise AssertionError(f"{k} at device_threshold {thr}: the "
                                     f"card's response differs from the "
                                     f"numpy route")
            per_q[k] = {r: n - before[r]
                        for r, n in eng.routes.expansions.items()
                        if n - before[r]}
        routes[f"card{thr}"] = {"per_query": per_q,
                                "expansions": dict(eng.routes.expansions),
                                "edges": dict(eng.routes.edges),
                                "least_bytes": dict(eng.routes.least_bytes)}
    on_card = routes[f"card{LDBC_THRESHOLD}"]["per_query"]

    def device_served(q):
        return sum(on_card[q].get(r, 0) for r in ("device", "fused",
                                                  "program"))
    if not device_served("config3"):
        raise AssertionError("config 3 took no device expansion at "
                             f"device_threshold {LDBC_THRESHOLD}")
    if not sum(device_served(k) for k in queries if k != "config3"):
        raise AssertionError("the IC mix took no device expansion at "
                             f"device_threshold {LDBC_THRESHOLD}")
    mix_p50 = {}
    for route, eng in engines.items():
        with fusion(route != "host"):
            lat = {k: lat_ms(lambda q=q: eng.query_bytes(q), reps)
                   for k, q in queries.items()}
        p50[route] = {k: float(np.median(v)) for k, v in lat.items()}
        # the IC mix's p50: the median over every request of the 14
        # templates, each template weighted equally
        mix_p50[route] = float(np.median(
            [x for k, v in lat.items() if k != "config3" for x in v]))
    edges3 = config3_edges(want["config3"])
    seg_ab = None
    if torch.device(device).type == "cuda":
        with fusion(False):
            city = host.query(
                '{ q(func: eq(city, "%s")) { uid } }' % g.city[0])["q"]
        seg_ab = seg_map_ab(store, {
            "config3_hop1": store.rank_of([int(o["uid"], 16) for o in city]),
            "all_persons": store.rank_of(g.person_uids)}, device)
    card = p50[f"card{LDBC_THRESHOLD}"]
    prof = (ldbc_profile(engines[f"card{LDBC_THRESHOLD}"], queries)
            if torch.device(device).type == "cuda" else None)
    ops = None
    if prof is not None:
        ops = {}
        for per in prof["per_template"].values():
            for op, rec in per.items():
                if not isinstance(rec, dict):
                    continue
                o = ops.setdefault(op, {"calls": 0, "launches": 0,
                                        "host_us": 0.0, "device_us": 0.0})
                for k in o:
                    o[k] += rec[k]
        lb = routes[f"card{LDBC_THRESHOLD}"]["least_bytes"]
        # least-bytes bound of the two compute ops over this mix pass
        for op, route in (("hop.gather_edges", "device"),
                          ("level.expand_level", "fused")):
            if op in ops:
                ops[op]["bound_us"] = lb[route] / HBM_BYTES_PER_S * 1e6
    out = {"sf": sf, "seed": LDBC_SEED, "nodes": store.n_nodes,
           "edges": sum(store.rel(p).nnz for p in store.preds),
           "generator_edges": int(g.n_edges),
           "persons": int(g.n_persons), "generate_s": gen_s,
           "build_s": build_s, "byte_equal": True, "routes": routes,
           "p50_ms": p50, "ic_mix_p50_ms": mix_p50,
           "ic_mix_p50_ms_sum": {r: sum(v[k] for k in queries
                                        if k != "config3")
                                 for r, v in p50.items()},
           "config3_p50_ms": card["config3"], "config3_edges": edges3,
           "config3_edges_per_s": edges3 / (card["config3"] / 1e3),
           "profile": prof, "ops": ops, "seg_map_ab": seg_ab}
    return out


def batch_profile(run) -> dict | None:
    """One run under torch.profiler: device and wall time, the top
    kernels, and per lane-serving range (BATCH_RANGES) its calls, device
    launches, host and device microseconds. None when the profiler
    records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels: dict = {}
    for ev in events:
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    device_us = sum(kernels.values())
    if device_us <= 0:
        return None
    ranges: dict = {}
    for ev in events:
        if ev.device_type != DeviceType.CPU or ev.name not in BATCH_RANGES:
            continue
        rec = ranges.setdefault(ev.name, {"calls": 0, "launches": 0,
                                          "host_us": 0.0, "device_us": 0.0})
        rec["calls"] += 1
        rec["launches"] += device_launches(ev)
        rec["host_us"] += ev.cpu_time_total
        rec["device_us"] += ev.device_time_total
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": device_us, "wall_us": wall_us,
            "device_busy_share": device_us / wall_us,
            "bucket_hop_us": sum(us for k, us in kernels.items()
                                 if "bucket_hop" in k),
            "top_kernels_us": {k[:80]: v for k, v in top},
            "ranges": ranges}


def flat(out) -> list:
    """A program's outputs (tensors, tuples of tensors) as one list."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def same_masks(got, want) -> bool:
    a, b = flat(got), flat(want)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def tree_program(store, plan, device) -> dict:
    """One tree group's run on the kernel and on bucket_hop_plain, from
    the inputs serving would give it (engine/treebatch.py)."""
    from dgraph_tpu_torch.engine import treebatch
    from dgraph_tpu_torch.ops.bfs import make_ell_tree
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain

    inputs = treebatch._tree_inputs(store, plan, device, LDBC_THRESHOLD)
    if inputs is None:
        raise AssertionError("a tree group has no kernel inputs")
    rels, seed_lists, filt_lists, _sidx, _disp = inputs
    n, lanes = store.n_nodes, treebatch._lanes(plan)
    W = lanes // 32
    fn, descs = treebatch._tree_kernel_for(store, plan, rels, n, W, device)
    seeds, filts = treebatch._tree_masks(n, lanes, seed_lists, filt_lists,
                                         device)
    row = 4 * W
    # least bytes: every seed and filter mask and each graph's index
    # blocks and two permutation vectors read once; every stage output
    # (a recurse stage's per-hop masks too) written once
    nbytes = ((len(seeds) + len(filts)) * (n + 1) * row
              + sum(4 * (g.padded_edges + sum(int(t.size) for t in g.lvl2))
                    + 16 * (n + 1) for g in rels.values())
              + sum((n + 1) * row * (1 + (s.depth if s.keep_hops else 0))
                    for s in plan.stages))
    return {"run": lambda: fn(seeds, filts),
            "plain": lambda: make_ell_tree(descs, n, W,
                                           hop=bucket_hop_plain)(seeds,
                                                                 filts),
            "W": W, "stages": [s.kind for s in plan.stages],
            "bytes": nbytes}


def step_program(store, device, seeds_uids, first_visit: bool,
                 hops: int) -> dict:
    """One make_ell_step stage over `knows` from one person per lane, on
    the kernel and on bucket_hop_plain, with fresh carries per call."""
    from dgraph_tpu_torch.engine.batch import _dev_for, _lane_count
    from dgraph_tpu_torch.ops.bfs import (make_ell_step, pack_seed_masks,
                                          put_mask)
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop_plain

    g, dev = _dev_for(store, "knows", False, device)
    ranks = store.rank_of(np.asarray(seeds_uids, np.int64))
    lanes = _lane_count(len(ranks))
    lists = [[r] for r in ranks] + [[]] * (lanes - len(ranks))
    mask0 = pack_seed_masks(g, lists)
    W = mask0.shape[1]
    step = make_ell_step(dev, g.n, W, first_visit=first_visit)
    plain = make_ell_step(dev, g.n, W, first_visit=first_visit,
                          hop=bucket_hop_plain)

    def carries():
        return put_mask(mask0, device), put_mask(mask0, device)

    row = 4 * W
    # least bytes: frontier and seen read once, the index blocks once,
    # the per-hop masks written once (and seen, when first-visit)
    nbytes = (2 * (g.n + 1) * row
              + 4 * (g.padded_edges + sum(int(t.size) for t in g.lvl2))
              + hops * (g.n + 1) * row
              + ((g.n + 1) * row if first_visit else 0))
    return {"run": lambda fs: step(*fs, hops),
            "plain": lambda fs: plain(*fs, hops), "carries": carries,
            "W": W, "bytes": nbytes}


def held(name: str, prog, reps: int, with_carries: bool = False) -> dict:
    """Run a program once on the kernel (its launches counted) and once
    on the plain hop, equal mask for mask; then its CUDA-event time
    (median of reps), the plain run's time and the least-bytes bound."""
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES

    def arg():
        return prog["carries"]() if with_carries else None

    def call(which, a):
        return prog[which](a) if with_carries else prog[which]()

    setup = arg if with_carries else None
    before = LAUNCHES["bucket_hop"]
    got = call("run", arg())
    torch.cuda.synchronize()
    launches = LAUNCHES["bucket_hop"] - before
    box = {}
    plain_ms = cuda_ms(lambda a: box.__setitem__("out", call("plain", a)),
                       1, setup=setup)
    if not same_masks(got, box.pop("out")):
        raise AssertionError(f"{name}: kernel run != plain-hop run")
    del got
    ms = cuda_ms(lambda a: call("run", a), reps, setup=setup)
    bound_ms = prog["bytes"] / HBM_BYTES_PER_S * 1e3
    return {"W": prog["W"], "launches": launches, "ms": ms,
            "median_ms": float(np.median(ms)), "plain_ms": plain_ms[0],
            "bytes": prog["bytes"], "bound_ms": bound_ms,
            "bound_by": "bytes", "equal_to_plain": True}


def phase_ic_batch(device, built: dict, copies: int = IC_BATCH_COPIES,
                   ic14: int = IC14_COPIES,
                   kernel_lanes: int = KERNEL_LANES,
                   reps: int = REPS) -> dict:
    """Lane-kernel serving of the LDBC IC mix (phase 7)."""
    from dgraph_tpu_torch.engine import Engine, batch
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES

    g, store = built["g"], built["store"]
    pairs = ldbc.ic_batch(g, copies=copies, seed=IC_BATCH_SEED,
                          ic14_copies=ic14)
    names = [nm for nm, _q in pairs]
    qs = [q for _nm, q in pairs]
    plans, leftover = batch.plan_batch_groups_cached(store, qs)
    family = {"TreePlan": "tree", "_ShortestPlan": "shortest",
              "_BatchPlan": "recurse"}
    groups = [{"family": family[type(p).__name__],
               "templates": sorted({names[i] for i in idxs}),
               "queries": len(idxs), "lanes": batch._lane_count(len(idxs))}
              for p, idxs in plans]
    want_family = {**{f"IC{i}": "tree" for i in range(1, 13)},
                   "IC13": "shortest", "config3": "tree"}
    got_family = {gr["templates"][0]: gr["family"] for gr in groups
                  if len(gr["templates"]) == 1 and gr["queries"] == copies}
    if got_family != want_family or len(groups) != len(want_family):
        raise AssertionError(f"IC batch groups {groups} != {want_family}")
    if sorted({names[i] for i in leftover}) != ["IC14"]:
        raise AssertionError(f"left to the per-query engine: {leftover}")

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got = batch.query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    again = batch.query_batch(store, qs, device=device)
    warm_s = time.perf_counter() - t0
    # on the card; a CPU rehearsal runs the plain hop, which counts none
    if torch.device(device).type == "cuda" and launches["bucket_hop"] < 1:
        raise AssertionError("the IC batch launched no bucket_hop")
    t0 = time.perf_counter()
    prof = (batch_profile(lambda: batch.query_batch(store, qs,
                                                    device=device))
            if torch.device(device).type == "cuda" else None)
    profile_s = time.perf_counter() - t0
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    t0 = time.perf_counter()
    want = [eng.query(q) for q in qs]
    per_query_s = time.perf_counter() - t0
    bad = sorted({names[i] for i in range(len(qs))
                  if json.dumps(got[i], sort_keys=True)
                  != json.dumps(want[i], sort_keys=True)
                  or json.dumps(again[i], sort_keys=True)
                  != json.dumps(want[i], sort_keys=True)})
    if bad:
        raise AssertionError(f"batch responses differ from the per-query "
                             f"engine for {bad}")
    if any("errors" in r for r in got):
        raise AssertionError("a batch response is an error object")

    # every program of the batch against its plain-hop run, mask for mask
    t0 = time.perf_counter()
    serving = {}
    for (plan, idxs), gr in zip(plans, groups):
        tname = gr["templates"][0]
        if gr["family"] == "tree":
            serving[tname] = held(tname, tree_program(store, plan, device),
                                  1)
        elif gr["family"] == "shortest":
            serving[tname] = held(
                tname, step_program(store, device, plan.src_uids,
                                    plan.first_visit, STEP_HOPS), 1, True)

    serving_s = time.perf_counter() - t0

    # kernel-only at kernel_lanes
    t0 = time.perf_counter()
    big = ldbc.ic_batch(g, copies=kernel_lanes, seed=IC_BATCH_SEED + 1,
                        ic14_copies=0)
    kernel_only = {}
    for tname in KERNEL_TEMPLATES:
        tq = [q for nm, q in big if nm == tname]
        (plan, _idxs), = batch.plan_batch_groups_cached(store, tq)[0]
        kernel_only[tname] = held(tname, tree_program(store, plan, device),
                                  reps)
    starts = [int(q.split("from: ")[1].split(",")[0], 16)
              for nm, q in big if nm == "IC13"]
    for fv in (True, False):
        kernel_only[f"step_first_visit_{fv}"] = held(
            f"step first_visit={fv}",
            step_program(store, device, starts, fv, STEP_HOPS), reps, True)

    kernel_only_s = time.perf_counter() - t0
    ranges = prof["ranges"] if prof else {}
    return {"queries": len(qs), "groups": groups,
            "leftover": len(leftover), "bucket_hop_launches": launches,
            "equal_to_per_query_engine": True, "cold_s": cold_s,
            "warm_s": warm_s, "per_query_engine_s": per_query_s,
            "warm_over_per_query": warm_s / per_query_s,
            "profile": prof, "profile_s": profile_s,
            "tree_run_device_ms": ranges.get("batch.tree_run", {}).get(
                "device_us", 0.0) / 1e3,
            "step_run_device_ms": ranges.get("batch.step_run", {}).get(
                "device_us", 0.0) / 1e3,
            "serving_programs": serving, "serving_programs_s": serving_s,
            "kernel_only": kernel_only, "kernel_only_s": kernel_only_s}


def phase_features(device, g, store) -> dict:
    """Per-query and batched serving of the DQL-feature mix (phase 8) on
    `store`, a store of `g` holding at least feature_mix's schema and
    values (main passes build_graphrag_store's, timed there)."""
    from dgraph_tpu_torch.engine import Engine, batch
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    from dgraph_tpu_torch.tools import feature_mix

    queries = feature_mix.templates(g)
    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    t0 = time.perf_counter()
    with fusion(False):     # the pure numpy route
        want = {k: host.query_bytes(q) for k, q in queries.items()}
    host_pass_s = time.perf_counter() - t0
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per = {}
    for k, q in queries.items():
        before = dict(eng.routes.expansions)
        t0 = time.perf_counter()
        got = eng.query_bytes(q)
        cold_ms = (time.perf_counter() - t0) * 1e3
        if got != want[k]:
            raise AssertionError(f"{k}: the card's response differs from "
                                 f"the numpy route")
        warm = lat_ms(lambda q=q: eng.query_bytes(q), FEATURE_REPS)
        per[k] = {"cold_ms": cold_ms, "p50_ms": float(np.median(warm)),
                  "response_bytes": len(got),
                  "expansions": {r: n - before[r]
                                 for r, n in eng.routes.expansions.items()
                                 if n - before[r]}}
    prof = (ldbc_profile(eng, queries)
            if torch.device(device).type == "cuda" else None)
    if prof is not None:
        for k, rec in prof["per_template"].items():
            if k in per:
                per[k]["profiled_wall_us"] = rec.get("wall_us")
                per[k]["device_us"] = rec.get("device_us")
        prof = {k: v for k, v in prof.items() if k != "per_template"}

    pairs = feature_mix.batch(g, copies=FEATURE_COPIES)
    names = [nm for nm, _q in pairs]
    qs = [q for _nm, q in pairs]
    plans, leftover = batch.plan_batch_groups_cached(store, qs)
    family = {"TreePlan": "tree", "_ShortestPlan": "shortest",
              "_BatchPlan": "recurse"}
    families: dict = {"tree": [], "recurse": [], "shortest": [],
                      "left over": sorted({names[i] for i in leftover})}
    for p, idxs in plans:
        families[family[type(p).__name__]].append(
            sorted({names[i] for i in idxs}))
    in_tree = {nm for grp in families["tree"] for nm in grp}
    if not {"agg_minmax", "math"} <= in_tree:
        raise AssertionError(f"agg_minmax and math must run as tree "
                             f"groups: {families}")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    got = batch.query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    again = batch.query_batch(store, qs, device=device)
    warm_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda" and launches["bucket_hop"] < 1:
        raise AssertionError("the feature batch launched no bucket_hop")
    card = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per_query, per_query_ms = [], []
    for q in qs:
        t0 = time.perf_counter()
        per_query.append(card.query(q))
        per_query_ms.append((time.perf_counter() - t0) * 1e3)
    per_query_s = sum(per_query_ms) / 1e3
    bad = sorted({names[i] for i in range(len(qs))
                  if json.dumps(got[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)
                  or json.dumps(again[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)})
    if bad:
        raise AssertionError(f"feature batch responses differ from the "
                             f"per-query engine for {bad}")
    if any("errors" in r for r in got):
        raise AssertionError("a feature batch response is an error object")
    # a third, profiled warm batch: the tree groups' run and rebuild and
    # the left-over queries, each beside the per-query engine's time for
    # the same queries
    t0 = time.perf_counter()
    batch_prof = (batch_profile(lambda: batch.query_batch(store, qs,
                                                          device=device))
                  if torch.device(device).type == "cuda" else None)
    batch_profile_s = time.perf_counter() - t0
    in_groups = {i for _p, idxs in plans for i in idxs}
    split = {"tree groups": {"per_query_engine_ms": sum(
                 ms for i, ms in enumerate(per_query_ms) if i in in_groups)},
             "left over": {"per_query_engine_ms": sum(
                 ms for i, ms in enumerate(per_query_ms)
                 if i not in in_groups)}}
    if batch_prof is not None:
        rng = batch_prof["ranges"]
        for part, keys in (("tree groups", ("batch.tree_run",
                                            "batch.tree_rebuild")),
                           ("left over", ("batch.leftover",))):
            for key in keys:
                rec = rng.get(key, {})
                split[part][key] = {"host_ms": rec.get("host_us", 0.0) / 1e3,
                                    "device_ms":
                                        rec.get("device_us", 0.0) / 1e3}
    return {"nodes": store.n_nodes,
            "host_pass_s": host_pass_s, "byte_equal": True,
            "templates": per,
            "p50_ms_median": float(np.median([r["p50_ms"]
                                              for r in per.values()])),
            "profile": prof, "batch_queries": len(qs),
            "batch_families": families, "bucket_hop_launches": launches,
            "batch_equal_to_per_query_engine": True,
            "batch_cold_s": cold_s, "batch_warm_s": warm_s,
            "per_query_engine_s": per_query_s,
            "warm_over_per_query": warm_s / per_query_s,
            "batch_profile": batch_prof, "batch_profile_s": batch_profile_s,
            "batch_split": split}


def template_launches(eng, queries: dict, on: bool) -> dict | None:
    """One pass of the templates under torch.profiler with whole-block
    programs on or off: per template the device launches (kernels and
    copies) and device microseconds the profiler attributes to it. The
    profiler sees no kernel inside a graph replay, so with programs on
    these are the launches outside the graphs. None when the profiler
    records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with fusion(on), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        for name, q in queries.items():
            with record_function("ldbc." + name):
                eng.query_bytes(q)
        torch.cuda.synchronize()
    events = prof.events()
    if not any(ev.device_type == DeviceType.CUDA for ev in events):
        return None
    return {ev.name[5:]: {"launches": device_launches(ev),
                          "device_us": ev.device_time_total}
            for ev in events
            if ev.device_type == DeviceType.CPU
            and ev.name.startswith("ldbc.")}


def eager_launches(fn) -> int:
    """Device launches (kernels, copies, fills) of one eager fn() under
    torch.profiler: for a captured program's plain function, the nodes
    its graph replays. One profiled run of config 3's masked hop once
    counted 19 launches against 106-109 in every other run, so it takes
    the larger count of two runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for ev in prof.events()
                          if ev.device_type == DeviceType.CUDA
                          and not getattr(ev, "is_user_annotation", False)))
    return max(counts)


def csr_ab(store, seed: int = CSR_SEED) -> dict:
    """The CSR builder two ways on every uid predicate of the store, both
    directions, from its edge pairs in a seeded shuffled order: the
    native builder (native/csr.cpp) and the numpy one. Equal arrays
    asserted; host seconds of each, summed."""
    from dgraph_tpu_torch.store.store import (_csr_from_pairs,
                                              _csr_from_pairs_np)

    rng = np.random.default_rng(seed)
    n = store.n_nodes
    native_s = numpy_s = 0.0
    pairs = 0
    for pred, pd in store.preds.items():
        if pd.fwd is None:
            continue
        deg = np.diff(pd.fwd.indptr)
        src = np.repeat(np.arange(n, dtype=np.int32), deg)
        dst = pd.fwd.indices
        perm = rng.permutation(len(src))
        for s, o in ((src[perm], dst[perm]), (dst[perm], src[perm])):
            t0 = time.perf_counter()
            a = _csr_from_pairs(s, o, n)
            native_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            b = _csr_from_pairs_np(s, o, n)
            numpy_s += time.perf_counter() - t0
            if not (np.array_equal(a.indptr, b.indptr)
                    and np.array_equal(a.indices, b.indices)):
                raise AssertionError(f"native CSR of {pred} != numpy CSR")
            pairs += len(s)
    return {"pairs": pairs, "native_s": native_s, "numpy_s": numpy_s,
            "equal": True}


def program_least_bytes(p, n_nodes: int) -> int:
    """Least bytes of a whole-block program's last call: each stage's
    input frontier, its rows' indptr pairs, the edges' indices and its
    allowed set read once; every output slot written once (and a recurse
    stage's seen bitmap cleared once)."""
    split, n_roots = p.last
    f_cap, a_caps = p.layout
    total = 4 * (f_cap + sum(a_caps))         # the packed input
    fcap = {-1: f_cap}
    nfront = {-1: n_roots}
    for i, (st, sz) in enumerate(zip(p.stages, split)):
        a = 4 * a_caps[i] if st.has_filter else 0
        if st.kind == "hop":
            ecap = p.caps[i][0]
            _n_kept, n_unique, edges = (int(v) for v in sz)
            total += (4 * fcap[st.parent] + 8 * nfront[st.parent]
                      + 4 * edges + a + 16 * ecap + 12)
            fcap[i], nfront[i] = ecap, n_unique
        elif st.kind == "recurse":
            ecap, ocap = p.caps[i]
            _kept_h, uniq_h, tot_h = sz
            fronts = [nfront[st.parent]] + [int(u) for u in uniq_h[:-1]]
            total += n_nodes + 1
            for h in range(st.depth):
                total += (4 * ocap + 8 * fronts[h] + 4 * int(tot_h[h]) + a
                          + 8 * ecap + 4 * ocap + 12)
        elif st.kind == "knn":
            # the tablet, its ranks and the query read once, the seeds
            # written once
            subj, vecs = p.rels[i]
            k = min(st.k, int(subj.shape[0]))
            total += 4 * vecs.numel() + 4 * subj.numel() + 4 * p.caps[i][0]
            fcap[i], nfront[i] = p.caps[i][0], k
        elif st.kind == "featprop":
            # per hop: its kept edges' (nbr, seg), each fresh node's row
            # (every kept edge ends in the hop's fresh set) and the
            # outputs; a lower bound when a neighbour has no row
            d = int(p.rels[i][1].shape[1])
            kept_h, uniq_h, _tot_h = split[st.parent]
            ocap = p.caps[st.parent][1]
            for h in range(len(kept_h)):
                total += (8 * int(kept_h[h]) + 4 * d * int(uniq_h[h])
                          + (4 * d + 8) * ocap)
        else:
            total += (4 * fcap[st.parent] + 8 * nfront[st.parent]
                      + 4 * fcap[st.parent])
    return total


def masked_hop_row(store, q: str, device) -> dict:
    """ops/recurse.masked_hop alone at config 3's first hop (its roots,
    its filter's allowed set, the caps its program settled on): launches,
    device ms (CUDA events, median of REPLAY_REPS) and the least-bytes
    bound (frontier, the rows' indptr pairs, the edges' indices, the
    allowed set and the seen bitmap read once; kept edges, rows and the
    next frontier written once)."""
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import fused
    from dgraph_tpu_torch.engine.execute import Executor, _bucket
    from dgraph_tpu_torch.ops.recurse import masked_hop, seen_bitmap
    from dgraph_tpu_torch.ops.uidalgebra import pad_to

    sg = parse(q)[0]
    plan = fused.plan_block(store, sg)
    st, esg = plan.stages[0], plan.stage_sgs[0]
    ex = Executor(store, device=device)
    roots = np.unique(ex.root_display(sg)).astype(np.int32)
    allowed = ex.filter_set(esg.filters)
    rel = store.rel(st.attr, st.reverse)
    caps = fused._estimate_caps(plan, [rel], roots)[0]
    ecap = max(caps[0], _bucket(int(rel.degree(roots).sum())))
    ocap = caps[1]
    indptr, indices = store.device_rel(st.attr, st.reverse, device)
    fr = pad_to(roots, ocap, device)
    a_d = pad_to(allowed, _bucket(max(len(allowed), 1)), device)
    seen = seen_bitmap(store.n_nodes, fr)

    def run(_a=None):
        # each run marks more of `seen`; every op keeps its fixed shape
        return masked_hop(indptr, indices, fr, a_d, seen, ecap, ocap, True)

    total = int(run()[6])
    ms = cuda_ms(run, REPLAY_REPS)
    nbytes = (4 * ocap + 8 * len(roots) + 4 * total + 4 * a_d.shape[0]
              + (store.n_nodes + 1) + 8 * ecap + 4 * ocap)
    return {"roots": len(roots), "edges": total, "edge_cap": ecap,
            "out_cap": ocap, "launches": eager_launches(run),
            "ms": float(np.median(ms)), "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def replay_rows(programs: dict, per: dict, n_nodes: int) -> int:
    """Each captured program of each template: one replay held bit for
    bit against an eager run of its plain function on the same inputs,
    then replay and eager ms (CUDA events), launches per replay and the
    least-bytes bound, into per[template]["programs"]. Returns the
    number checked."""
    checked = 0
    for k, progs in programs.items():
        rows = []
        for p in progs:
            with p.lock:
                p.graph.replay()
                got = [t.clone() for t in flat(p.static_out)]
                ref = flat(p.fn(p.rels, p.static_in))
                if len(got) != len(ref) or not all(
                        torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{k}: a graph replay differs "
                                         f"from its eager run")
                ms = cuda_ms(lambda _a, p=p: p.graph.replay(), REPLAY_REPS)
                eager = cuda_ms(lambda _a, p=p: p.fn(p.rels, p.static_in),
                                REPLAY_REPS)
                launches = eager_launches(
                    lambda p=p: p.fn(p.rels, p.static_in))
            checked += 1
            nbytes = program_least_bytes(p, n_nodes)
            rows.append({"replay_ms": float(np.median(ms)),
                         "eager_ms": float(np.median(eager)),
                         "launches_per_replay": launches,
                         "graph_bytes": p.graph_bytes,
                         "least_bytes": nbytes,
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes", "equal_to_eager": True})
        per[k]["programs"] = rows
    return checked


def phase_fused(device, built: dict) -> dict:
    """Whole-block programs and the native emitter on the SF1 store of
    phase 6 (phase 9)."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import Engine, emit, fused
    from dgraph_tpu_torch.models import ldbc
    from dgraph_tpu_torch.store.store import StoreBuilder

    on_card = torch.device(device).type == "cuda"
    g, store = built["g"], built["store"]
    queries = dict(ldbc.ic_templates(g))
    queries["config3"] = ldbc.config3_query(g)
    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    with fusion(False):
        want = {k: host.query_bytes(q) for k, q in queries.items()}

    fused.reset()
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved() if on_card else 0
    emitted = dict(emit.COUNTS)
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per, programs = {}, {}
    eligible_total = 0
    for k, q in queries.items():
        plans = [fused.plan_block(store, sg) for sg in parse(q)]
        eligible = sum(p is not None for p in plans)
        eligible_total += eligible
        before, had = fused.status(), set(map(id, fused.captured()))
        t0 = time.perf_counter()
        with fusion(True):
            got = eng.query_bytes(q)
        cold_ms = (time.perf_counter() - t0) * 1e3
        after = fused.status()
        if got != want[k]:
            raise AssertionError(f"{k}: fused response differs from the "
                                 f"numpy route")
        served = after["routes"]["fused"] - before["routes"]["fused"]
        if served < eligible:
            raise AssertionError(f"{k}: {served} blocks fused of "
                                 f"{eligible} eligible")
        programs[k] = [p for p in fused.captured() if id(p) not in had]
        per[k] = {"blocks": [[s.kind for s in p.stages] if p else None
                             for p in plans],
                  "fused_blocks": served,
                  "caps": [list(fused._caps_memo.get(p.sig, ()))
                           for p in plans if p is not None],
                  "captures": after["captures"] - before["captures"],
                  "capture_ms": after["capture_ms"] - before["capture_ms"],
                  "cold_ms": cold_ms}
    # p50 with whole-block programs on and off, requests interleaved
    lat = {k: {"on": [], "off": []} for k in queries}
    for _ in range(FUSED_REPS):
        for k, q in queries.items():
            for arm in ("on", "off"):
                with fusion(arm == "on"):
                    t0 = time.perf_counter()
                    got = eng.query_bytes(q)
                    lat[k][arm].append((time.perf_counter() - t0) * 1e3)
                if got != want[k]:
                    raise AssertionError(f"{k}: fused {arm} differs from "
                                         f"the numpy route")
    for k in queries:
        per[k]["p50_ms_on"] = float(np.median(lat[k]["on"]))
        per[k]["p50_ms_off"] = float(np.median(lat[k]["off"]))
    # render alone: the native emitter against the dict renderer on the
    # same executed tree, equal bytes
    for k, q in queries.items():
        roots, ex = eng._run(q)
        for arm in ("native", "dict"):
            native.HAVE_EMIT = arm == "native"
            try:
                ms = []
                for _ in range(FUSED_REPS):
                    t0 = time.perf_counter()
                    got = emit.to_json_bytes(ex, roots)
                    ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                native.HAVE_EMIT = True
            if got != want[k]:
                raise AssertionError(f"{k}: {arm} render differs")
            per[k][f"render_ms_{arm}"] = float(np.median(ms))
    mix = [k for k in queries if k != "config3"]
    status = fused.status()
    if status["fallbacks"] or status["routes"]["fallback"] \
            or status["disabled"]:
        raise AssertionError(f"fused fallbacks: {status}")
    if status["routes"]["fused"] < eligible_total * (1 + FUSED_REPS):
        raise AssertionError(f"fused route served {status['routes']} of "
                             f"{eligible_total} eligible blocks per pass")

    # every captured program: one replay against an eager run of its
    # plain function on the same inputs, bit for bit; its replay time
    checked = 0
    if on_card:
        checked = replay_rows(programs, per, store.n_nodes)
        programs.clear()      # reset() below may then free the graphs
        if checked != status["captures"] or not checked:
            raise AssertionError(f"{checked} captured programs checked of "
                                 f"{status['captures']} captures")
        for arm in ("on", "off"):
            prof = template_launches(eng, queries, arm == "on")
            for k, rec in (prof or {}).items():
                per[k][f"launches_{arm}"] = rec["launches"]
                per[k][f"device_us_{arm}"] = rec["device_us"]
    hop_row = masked_hop_row(store, queries["config3"], device) \
        if on_card else None
    n_native = emit.COUNTS["native"] - emitted["native"]
    if not (native.HAVE_EMIT and native.built()) or n_native < 1:
        raise AssertionError(f"the native emitter served {n_native} blocks "
                             f"(HAVE_EMIT {native.HAVE_EMIT}, built "
                             f"{native.built()})")
    # device memory the phase leaves behind: the graphs' pools (within
    # PROGRAM_BYTES) and nothing else; after reset() the pools go back
    memory = {"reserved_before": reserved0, "limit": fused.PROGRAM_BYTES,
              "program_bytes": status["program_bytes"],
              "programs": status["programs"],
              "evictions": status["evictions"]}
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        memory["reserved_after"] = torch.cuda.memory_reserved()
        grown = memory["reserved_after"] - reserved0
        if grown > fused.PROGRAM_BYTES or \
                status["program_bytes"] > fused.PROGRAM_BYTES:
            raise AssertionError(f"phase 9 left {grown} bytes reserved on "
                                 f"the card: {memory}")
    fused.reset()
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        memory["reserved_after_reset"] = torch.cuda.memory_reserved()
    # the store build: native CSR (phase 6's) against the numpy builder
    t0 = time.perf_counter()
    native.HAVE_NATIVE = False
    try:
        b = StoreBuilder()
        ldbc.load_into(b, g)
        numpy_store = b.finalize()
    finally:
        native.HAVE_NATIVE = True
    numpy_build_s = time.perf_counter() - t0
    for pred, pd in store.preds.items():
        for d in ("fwd", "rev"):
            a, b2 = getattr(pd, d), getattr(numpy_store.preds[pred], d)
            if (a is None) != (b2 is None) or (a is not None and not (
                    np.array_equal(a.indptr, b2.indptr)
                    and np.array_equal(a.indices, b2.indices))):
                raise AssertionError(f"{pred} {d}: native and numpy "
                                     f"builders differ")
    del numpy_store
    return {"byte_equal": True, "eligible_blocks_per_pass": eligible_total,
            "status": status,
            "programs_checked": checked, "templates": per,
            "mix_p50_ms_on": float(np.median(
                [x for k in mix for x in lat[k]["on"]])),
            "mix_p50_ms_off": float(np.median(
                [x for k in mix for x in lat[k]["off"]])),
            "render_ms_sum": {arm: sum(r[f"render_ms_{arm}"]
                                       for r in per.values())
                              for arm in ("native", "dict")},
            "memory": memory,
            "masked_hop_config3_hop1": hop_row,
            "native": {"have_emit": native.HAVE_EMIT,
                       "built": native.built(),
                       "blocks_emitted": n_native,
                       "blocks_dict": emit.COUNTS["dict"] - emitted["dict"],
                       "store_build_s_native": built["build_s"],
                       "store_build_s_numpy": numpy_build_s,
                       "csr": csr_ab(store)}}


# -- phase 10: GraphRAG retrieval and @msgpass -----------------------------------

def combine_case(rng, d: int, n_seg: int, n_edges: int, sort: bool,
                 integer: bool, hub: bool = False):
    """One random segment_combine input on the host: a tablet of 3000
    rows over a 12000-rank space (a quarter of the neighbours have a
    row), duplicate edges, a quarter of the segments empty, one segment
    whose neighbours all lack a row, a sentinel-padded tail of 37 dead
    slots; `hub` puts ~97 % of the edges in segment 0."""
    rows, space = 3000, 12000
    subj = np.sort(rng.choice(space, rows, replace=False)).astype(np.int32)
    vecs = (rng.integers(-3, 4, (rows, d)) if integer
            else rng.standard_normal((rows, d))).astype(np.float32)
    # half the neighbours from the tablet, half from the whole space
    nbrs = np.where(rng.random(n_edges) < 0.5,
                    rng.choice(subj, n_edges),
                    rng.integers(0, space, n_edges)).astype(np.int32)
    tenth = n_edges // 10
    nbrs[:tenth] = nbrs[tenth:2 * tenth]          # duplicate edges
    live = rng.choice(n_seg, max(n_seg * 3 // 4, 1), replace=False)
    seg = live[rng.integers(0, len(live), n_edges)].astype(np.int32)
    if hub:
        seg = np.where(rng.random(n_edges) < 0.97, 0, seg).astype(np.int32)
    nbrs[seg == live[-1]] = space + 1             # no row for these
    if sort:
        order = np.argsort(seg, kind="stable")
        nbrs, seg = nbrs[order], seg[order]
    snt = np.iinfo(np.int32).max
    nbrs = np.concatenate([nbrs, np.full(37, snt, np.int32)])
    seg = np.concatenate([seg, np.zeros(37, np.int32)])
    return subj, vecs, nbrs, seg, n_edges, n_seg


def bits_equal(a, b) -> bool:
    a = torch.as_tensor(a).contiguous().view(torch.int32).cpu()
    b = torch.as_tensor(b).contiguous().view(torch.int32).cpu()
    return a.shape == b.shape and torch.equal(a, b)


def phase_combine_cases(device) -> dict:
    """segment_combine against its plain version and host_combine on the
    card (phase 10 a). Integer-valued features: bit-exact against
    segment_combine_plain (order-free sums). N(0,1) features: bit-exact
    against engine/feat.host_combine (numpy, edge order) and against a
    second run of the kernel. Sorted seg runs with seg_sorted=True."""
    from dgraph_tpu_torch.engine.feat import host_combine
    from dgraph_tpu_torch.ops.feat import (AGGS, segment_combine,
                                           segment_combine_plain)

    rng = np.random.default_rng(COMBINE_SEED)
    cases = [(d, agg, sort, integer, False, COMBINE_EDGES, 300)
             for d in COMBINE_DIMS for agg in AGGS
             for sort in (False, True) for integer in (True, False)]
    cases += [(384, agg, sort, True, True, HUB_EDGES, 4)
              for agg in AGGS for sort in (False, True)]
    cases += [(384, agg, False, False, True, HUB_EDGES, 4)
              for agg in ("sum", "mean")]
    checked = 0
    for d, agg, sort, integer, hub, n_edges, n_seg in cases:
        subj, vecs, nbrs, seg, n, k = combine_case(
            rng, d, n_seg, n_edges, sort, integer, hub)
        t = [torch.from_numpy(a).to(device) for a in (subj, vecs, nbrs, seg)]
        live = torch.tensor(n, dtype=torch.int32, device=device)
        got = segment_combine(*t, live, k, agg, seg_sorted=sort)
        if integer:
            want = segment_combine_plain(*t, n, k, agg)
        else:
            want = host_combine(subj, vecs, nbrs[:n], seg[:n], k, agg)
            again = segment_combine(*t, n, k, agg, seg_sorted=sort)
            if not all(bits_equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"segment_combine d={d} {agg}: two "
                                     f"runs differ")
        if not all(bits_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(
                f"segment_combine d={d} {agg} sorted={sort} "
                f"integer={integer} hub={hub}: differs from "
                f"{'the plain version' if integer else 'host_combine'}")
        if not torch.isfinite(got[0]).all():
            raise AssertionError(f"segment_combine d={d} {agg}: non-finite")
        checked += 1
    torch.cuda.synchronize()
    return {"cases": checked, "dims": list(COMBINE_DIMS),
            "hub_edges": HUB_EDGES, "max_abs_err": 0.0}


def build_graphrag_store(g):
    """Phase 8's feature store with tools/graphrag_mix.py's `emb`
    predicate: one SF1 build serves phases 8 and 10."""
    from dgraph_tpu_torch.store.store import StoreBuilder
    from dgraph_tpu_torch.tools import feature_mix, graphrag_mix

    t0 = time.perf_counter()
    b = StoreBuilder()
    feature_mix.load_into(b, g)
    graphrag_mix.load_into(b, g)
    store = b.finalize()
    t = store.vec_tablet("emb")
    return store, {"build_s": time.perf_counter() - t0, "rows": t.rows,
                   "dim": t.dim, "tablet_bytes": int(t.vecs.nbytes)}


def combine_row(fn, plain, library, nbytes: int) -> dict:
    """CUDA-event ms (median of REPLAY_REPS) of the kernel, its plain
    version and the library yardstick, beside the least-bytes bound."""
    fn(None), plain(None), library(None)
    return {"ms": float(np.median(cuda_ms(fn, REPLAY_REPS))),
            "plain_ms": float(np.median(cuda_ms(plain, REPLAY_REPS))),
            "library_ms": float(np.median(cuda_ms(library, REPLAY_REPS))),
            "least_bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def combine_timing(store, device, nbrs, seg, n_seg: int, agg: str,
                   seg_sorted: bool = False) -> dict:
    """segment_combine alone at one real shape (host arrays of the live
    edges): kernel, plain version, and `index_add_` of the already
    gathered participating rows (the sum alone, a yardstick). Least
    bytes: each edge's (nbr, seg) and each distinct participating row
    read once, the outputs written once."""
    from dgraph_tpu_torch.ops.feat import segment_combine, segment_combine_plain

    subj_d, vecs_d = store.vec_device("emb", device)
    t = store.vec_tablet("emb")
    d = t.dim
    nb = torch.from_numpy(np.ascontiguousarray(nbrs, np.int32)).to(device)
    sg = torch.from_numpy(np.ascontiguousarray(seg, np.int32)).to(device)
    n = len(nbrs)
    idx = np.minimum(np.searchsorted(t.subj, nbrs), t.rows - 1)
    has = t.subj[idx] == nbrs
    rows = vecs_d[torch.from_numpy(idx[has]).to(device).long()]
    tgt = torch.from_numpy(seg[has].astype(np.int64)).to(device)
    acc = torch.zeros((n_seg, d), dtype=torch.float32, device=device)
    nbytes = 8 * n + 4 * d * len(np.unique(nbrs[has])) + (4 * d + 8) * n_seg

    def fn(_a):
        return segment_combine(subj_d, vecs_d, nb, sg, n, n_seg, agg,
                               seg_sorted=seg_sorted)

    def plain(_a):
        return segment_combine_plain(subj_d, vecs_d, nb, sg, n, n_seg, agg)

    # small-integer features: exact sums, so bit for bit in any order
    got, want = fn(None), plain(None)
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"segment_combine {agg} at {n} edges into "
                             f"{n_seg} segments differs from its plain "
                             f"version")
    row = combine_row(fn, plain, lambda _a: acc.index_add_(0, tgt, rows),
                      nbytes)
    row.update({"max_abs_err": float((got[0] - want[0]).abs().max())
                if got[0].numel() else 0.0, "edges": n, "participating": int(has.sum()),
                "segments": n_seg, "largest_segment": int(
                    np.bincount(seg, minlength=1).max()) if n else 0,
                "dim": d, "agg": agg})
    return row


def knn_timing(store, device, q: np.ndarray, k: int) -> dict:
    """The device top-k alone on the whole tablet: torch.mv + keyed
    torch.topk (store/vec.device_topk) beside its plain version (the
    reference's shape: the same keys fully sorted, the first k taken)
    and the least-bytes bound (the tablet and its ranks read once)."""
    from dgraph_tpu_torch.store.vec import device_topk, topk_keys

    subj_d, vecs_d = store.vec_device("emb", device)
    q_d = torch.from_numpy(q).to(device)

    def plain(_a):
        keys = topk_keys(torch.mv(vecs_d, q_d), subj_d)
        return torch.sort(subj_d[torch.sort(keys).indices[:k]]).values

    got = device_topk(subj_d, vecs_d, q_d, k)
    if not torch.equal(got, plain(None)):
        raise AssertionError("device top-k differs from its plain version")
    nbytes = int(vecs_d.numel() * 4 + subj_d.numel() * 4 + q_d.numel() * 4
                 + 4 * min(k, subj_d.numel()))
    return {"ms": float(np.median(cuda_ms(
                lambda _a: device_topk(subj_d, vecs_d, q_d, k), REPLAY_REPS))),
            "plain_ms": float(np.median(cuda_ms(plain, REPLAY_REPS))),
            "least_bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "rows": int(subj_d.numel()), "k": k,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def phase_graphrag(device, g, store) -> dict:
    """Per-query and batched serving of the GraphRAG mix (phase 10 b-d)."""
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import Engine, batch, fused
    from dgraph_tpu_torch.engine import feat as efeat
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES as HOP
    from dgraph_tpu_torch.ops.feat import LAUNCHES as COMBINE
    from dgraph_tpu_torch.store import vec
    from dgraph_tpu_torch.tools import graphrag_mix

    on_card = torch.device(device).type == "cuda"
    if on_card and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the knn scores must be "
                             "full float32")
    queries = graphrag_mix.templates(g)
    host = Engine(store, device="cpu", device_threshold=HOST_ONLY)
    t0 = time.perf_counter()
    with fusion(False):     # the pure numpy route
        want = {k: host.query_bytes(q) for k, q in queries.items()}
    host_pass_s = time.perf_counter() - t0
    fused.reset()
    vec.reset()
    efeat.reset()
    for d in (HOP, COMBINE):
        for k in d:
            d[k] = 0
    eng = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    per, programs = {}, {}
    expect = {"knn_hop": ["knn", "hop"], "knn_uid": ["knn", "hop"],
              "knn_recurse": ["knn", "recurse"],
              "featprop_sum": ["recurse", "featprop"],
              "featprop_mean": ["recurse", "featprop"],
              "featprop_max": ["recurse", "featprop"],
              "knn_featprop": ["knn", "recurse", "featprop"],
              "msgpass_author": None, "msgpass_hub": None}
    for k, q in queries.items():
        kinds = [[st.kind for st in p.stages] if p else None
                 for p in (fused.plan_block(store, sg) for sg in parse(q))]
        if kinds != [expect[k]]:
            raise AssertionError(f"{k}: planned {kinds}, want "
                                 f"{[expect[k]]}")
        before = (fused.status(), vec.status()["routes"],
                  efeat.status()["routes"], dict(eng.routes.expansions),
                  COMBINE["segment_combine"])
        had = set(map(id, fused.captured()))
        t0 = time.perf_counter()
        got = eng.query_bytes(q)
        cold_ms = (time.perf_counter() - t0) * 1e3
        if got != want[k]:
            raise AssertionError(f"{k}: the card's response differs from "
                                 f"the numpy route")
        warm = lat_ms(lambda q=q: eng.query_bytes(q), GRAPHRAG_REPS)
        after = fused.status()
        programs[k] = [p for p in fused.captured() if id(p) not in had]
        fused_blocks = after["routes"]["fused"] - before[0]["routes"]["fused"]
        per[k] = {"stages": kinds[0],
                  "fused_blocks": after["routes"]["fused"]
                  - before[0]["routes"]["fused"],
                  "captures": after["captures"] - before[0]["captures"],
                  "knn_routes": {r: n - before[1][r] for r, n in
                                 vec.status()["routes"].items()
                                 if n - before[1][r]},
                  "feat_routes": {r: n - before[2][r] for r, n in
                                  efeat.status()["routes"].items()
                                  if n - before[2][r]},
                  "expansions": {r: n - before[3][r] for r, n in
                                 eng.routes.expansions.items()
                                 if n - before[3][r]},
                  "segment_combine_launches":
                      COMBINE["segment_combine"] - before[4],
                  "segment_combine_per_replay":
                      [p.combines for p in programs[k]],
                  "cold_ms": cold_ms, "p50_ms": float(np.median(warm)),
                  "response_bytes": len(got)}
        if on_card and expect[k] is not None and not per[k]["fused_blocks"]:
            raise AssertionError(f"{k}: no block fused")
        if on_card and "featprop" in (expect[k] or ()):
            # one captured program serves every request of the
            # template: each fused block is one replay of its `combines`
            # launches; the rest are whole eager warm-up runs (one per
            # caps tried)
            p, = programs[k]
            replay = p.combines * fused_blocks
            eager = per[k]["segment_combine_launches"] - replay
            per[k]["segment_combine_replay_launches"] = replay
            if not p.combines or eager < p.combines or eager % p.combines:
                raise AssertionError(
                    f"{k}: {per[k]['segment_combine_launches']} "
                    f"segment_combine launches for {fused_blocks} replays "
                    f"of {p.combines} and whole warm-up runs")
    # the main path's launches in (b), read before the checks and
    # timings below launch the kernel themselves
    staged = sum(per[k]["segment_combine_launches"]
                 for k in ("msgpass_author", "msgpass_hub"))
    replayed = sum(r.get("segment_combine_replay_launches", 0)
                   for r in per.values())
    combine_b = COMBINE["segment_combine"]
    checked = 0
    if on_card:
        checked = replay_rows(programs, per, store.n_nodes)
        want_checked = sum(1 for k in programs for p in programs[k]
                           if any(st.kind in ("knn", "featprop")
                                  for st in p.stages))
        if not want_checked or checked < want_checked:
            raise AssertionError(f"{checked} captured programs checked, "
                                 f"{want_checked} with knn or featprop")
    fp_prog = (programs.get("featprop_mean") or [None])[0]
    if on_card and fp_prog is None:
        raise AssertionError("featprop_mean captured no program")
    programs.clear()

    # (c) one query_batch of knn_hop, knn_recurse and featprop_* queries
    pairs = graphrag_mix.batch(g, GRAPHRAG_KNN_COPIES, GRAPHRAG_FEAT_COPIES)
    names = [nm for nm, _q in pairs]
    qs = [q for _nm, q in pairs]
    plans, leftover = batch.plan_batch_groups_cached(store, qs)
    family = {"TreePlan": "tree", "_ShortestPlan": "shortest",
              "_BatchPlan": "recurse"}
    families: dict = {"tree": [], "recurse": [], "shortest": [],
                      "left over": sorted({names[i] for i in leftover})}
    for p, idxs in plans:
        families[family[type(p).__name__]].append(
            sorted({names[i] for i in idxs}))
    if (families["recurse"] != [["knn_recurse"]]
            or families["tree"] != [["knn_hop"]]
            or families["left over"] != ["featprop_max", "featprop_mean",
                                         "featprop_sum"]):
        raise AssertionError(f"GraphRAG batch planned {families}")
    for d in (HOP, COMBINE):
        for k in d:
            d[k] = 0
    t0 = time.perf_counter()
    got = batch.query_batch(store, qs, device=device)
    cold_s = time.perf_counter() - t0
    batch_hops = HOP["bucket_hop"]
    combine_c = COMBINE["segment_combine"]
    t0 = time.perf_counter()
    again = batch.query_batch(store, qs, device=device)
    warm_s = time.perf_counter() - t0
    if on_card and batch_hops < 1:
        raise AssertionError("the GraphRAG batch launched no bucket_hop")
    card = Engine(store, device=device, device_threshold=LDBC_THRESHOLD)
    t0 = time.perf_counter()
    per_query = [card.query(q) for q in qs]
    per_query_s = time.perf_counter() - t0
    bad = sorted({names[i] for i in range(len(qs))
                  if json.dumps(got[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)
                  or json.dumps(again[i], sort_keys=True)
                  != json.dumps(per_query[i], sort_keys=True)})
    if bad or any("errors" in r for r in got):
        raise AssertionError(f"GraphRAG batch responses differ from the "
                             f"per-query engine for {bad}")
    by_path = {"staged @msgpass (phase 10 b)": staged,
               "featprop program replays (phase 10 b)": replayed,
               "featprop program warm-ups (phase 10 b)":
                   combine_b - staged - replayed,
               "query_batch @msgpass, per query (phase 10 c)": combine_c}
    if on_card and not (batch_hops and staged and replayed and combine_c):
        raise AssertionError(f"phase 10 launched a kernel no time on a "
                             f"path: bucket_hop {batch_hops}, "
                             f"segment_combine {by_path}")
    status = fused.status()
    if status["fallbacks"] or status["routes"]["fallback"]:
        raise AssertionError(f"fused fallbacks: {status}")

    # (d) the device top-k and segment_combine alone at real shapes
    timing = {}
    if on_card:
        sg = parse(queries["knn_hop"])[0]
        timing["device_topk"] = knn_timing(
            store, device, vec.resolve_query(store, sg.func)[2],
            int(sg.func.args[0]))
        roots, _ex = eng._run(queries["msgpass_hub"])
        node = roots[0]
        timing["segment_combine_msgpass_hub"] = combine_timing(
            store, device,
            np.concatenate([c.matrix_child for c in node.children]),
            np.concatenate([c.matrix_seg for c in node.children]),
            len(node.nodes), "sum")
        # the template's own program, its inputs set by one more request
        prog = fp_prog
        eng.query_bytes(queries["featprop_mean"])
        with prog.lock:
            outs, _sz = prog.fn(prog.rels, prog.static_in)
        nbrs_h, seg_h, kept_h, fr_h, _t, _u = (t.cpu().numpy()
                                               for t in outs[0])
        hops = [combine_timing(store, device, nbrs_h[h][:kept_h[h]],
                               seg_h[h][:kept_h[h]], fr_h.shape[1], "mean",
                               seg_sorted=True)
                for h in range(len(kept_h))]
        timing["segment_combine_featprop_mean"] = {
            "per_hop": hops,
            **{key: sum(h[key] for h in hops)
               for key in ("ms", "plain_ms", "library_ms", "least_bytes",
                           "bound_ms")}, "bound_by": "bytes",
            "max_abs_err": max(h["max_abs_err"] for h in hops)}
    return {"store": {"nodes": store.n_nodes}, "host_pass_s": host_pass_s,
            "byte_equal": True, "templates": per,
            "p50_ms": {k: r["p50_ms"] for k, r in per.items()},
            "programs_checked": checked, "status": status,
            "knn": vec.status(), "feat": efeat.status(),
            "batch_queries": len(qs), "batch_families": families,
            "batch_bucket_hop_launches": batch_hops,
            "batch_cold_s": cold_s, "batch_warm_s": warm_s,
            "per_query_engine_s": per_query_s,
            "batch_equal_to_per_query_engine": True,
            "segment_combine_launches_by_path": by_path,
            "timing": timing}


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    device = "cuda"
    phase_build()
    from dgraph_tpu_torch.engine.batch import _ell_for

    t0 = time.perf_counter()
    store = build_store(N_NODES)
    g = _ell_for(store, "follows", False)
    say("setup store", nodes=store.n_nodes,
        edges=store.rel("follows").nnz, ell_slots=g.padded_edges,
        dense_buckets=sum(1 for k, _e, _r in g.parts if k == "ell"),
        tile_rows=0 if g.tiles is None else int(g.tiles.shape[0]),
        lvl2_buckets=[int(t.shape[1]) for t in g.lvl2],
        seconds=time.perf_counter() - t0)
    from dgraph_tpu_torch.ops.bfs import pack_seed_masks
    from dgraph_tpu_torch.tools.hop_profile import make_seeds
    hop = phase_kernels(g, device,
                        pack_seed_masks(g, make_seeds(N_NODES, LANES)))
    launches = phase_serve(store, device, N_NODES, SERVE_QUERIES,
                           SERVE_DEPTH)
    phase_bench(store, device, N_NODES, LANES, DEPTH, CHECK_LANES,
                hop["bound_ms"])
    del store, g
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES
    t0 = time.perf_counter()
    built = build_ldbc(LDBC_SF)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with no_fused_fallback("phase 6"):
        ldbc = phase_ldbc(device, built=built)
    # the per-query path runs torch ops only: no hand kernel of the repo
    # is on it, and these counts show none launched
    say("phase 6 ldbc", seconds=time.perf_counter() - t0,
        hand_kernel_launches=dict(LAUNCHES), **ldbc)
    t0 = time.perf_counter()
    with no_fused_fallback("phase 7"):
        ic = phase_ic_batch(device, built)
    say("phase 7 ic batch", seconds=time.perf_counter() - t0, **ic)
    t0 = time.perf_counter()
    fz = phase_fused(device, built)
    say("phase 9 fused", seconds=time.perf_counter() - t0, **fz)
    # phase 7's store (its placed graphs and programs) goes before the
    # feature and GraphRAG store is built from the same graph
    g = built["g"]
    del built
    gc.collect()
    torch.cuda.empty_cache()
    # one SF1 store with the feature mix's extension and the GraphRAG
    # embeddings serves phases 8 and 10
    t0 = time.perf_counter()
    store, emb = build_graphrag_store(g)
    say("setup graphrag store", seconds=time.perf_counter() - t0,
        nodes=store.n_nodes, **emb)
    t0 = time.perf_counter()
    with no_fused_fallback("phase 8"):
        feat = phase_features(device, g, store)
    say("phase 8 dql features", seconds=time.perf_counter() - t0, **feat)
    t0 = time.perf_counter()
    cases = phase_combine_cases(device)
    say("phase 10 graphrag kernel", seconds=time.perf_counter() - t0,
        **cases)
    t0 = time.perf_counter()
    with no_fused_fallback("phase 10"):
        rag = phase_graphrag(device, g, store)
    say("phase 10 graphrag", seconds=time.perf_counter() - t0, **rag)
    # the launches of each main path, counted from zero around its run
    paths = {"bucket_hop": {
                 "query_batch @recurse (phase 4)": launches["bucket_hop"],
                 "query_batch IC mix (phase 7)":
                     ic["bucket_hop_launches"]["bucket_hop"],
                 "query_batch DQL features (phase 8)":
                     feat["bucket_hop_launches"]["bucket_hop"],
                 "query_batch GraphRAG (phase 10)":
                     rag["batch_bucket_hop_launches"]},
             "segment_combine": rag["segment_combine_launches_by_path"]}
    hub = rag["timing"]["segment_combine_msgpass_hub"]
    errs = [cases["max_abs_err"], hub["max_abs_err"],
            rag["timing"]["segment_combine_featprop_mean"]["max_abs_err"]]
    measured = {"bucket_hop": hop,
                "segment_combine": {**hub, "max_abs_err": max(errs)}}
    say("script", seconds=time.perf_counter() - t_start)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": KERNEL_REPLACES[name],
                "launches": sum(paths[name].values()),
                "launches_by_path": paths[name],
                "max_abs_err": measured[name]["max_abs_err"],
                "ms": measured[name]["ms"],
                "plain_ms": measured[name]["plain_ms"],
                "bound_ms": measured[name]["bound_ms"],
                "bound_by": measured[name]["bound_by"],
                "library_ms": measured[name].get("library_ms")}
               for name, src in KERNEL_SOURCES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
