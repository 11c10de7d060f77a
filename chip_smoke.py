"""Drive the PyTorch port's batched @recurse path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises and exits non-zero:

  1. device   — needs torch.cuda; prints `nvidia-smi` name and power limit
  2. build    — compiles every CUDA kernel of the path from csrc/ (nvcc,
                all sources at once)
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bit-exact: random buckets (K in 1,3,8,32,1024; W in 1,2,128;
                sentinel rows; ragged row counts) and one full ELL hop on the
                bench graph at 4096 lanes; times kernel vs plain per hop
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
                numpy walk for 64 lanes
  6. the `kernels` JSON line, then the device JSON line last

It imports torch, numpy and dgraph_tpu_torch only.
"""

from __future__ import annotations

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
SEEDS_PER_QUERY = 4
REPS = 5
CHECK_LANES = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak (NVIDIA data sheet)
# no int32 ALU peak is published; the float32 non-tensor peak (67 T/s,
# same data sheet) stands in for the bitwise-OR rate
ALU_OPS_PER_S = 67e12
KERNEL_SOURCES = {"bucket_hop": "dgraph_tpu_torch/csrc/bucket_hop.cu"}
KERNEL_REPLACES = {"bucket_hop": "dgraph_tpu/ops/pallas_hop.py:108"}


def say(phase: str, **kv) -> None:
    print(f"{phase}: " + json.dumps(kv, default=str), flush=True)


def make_seeds(n, B, seed=7):
    """bench.py's seed draw: SEEDS_PER_QUERY random ranks per query."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, SEEDS_PER_QUERY) for _ in range(B)]


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
    say("phase 2 build", seconds=round(time.perf_counter() - t0, 3),
        built={k: {"seconds": round(v["seconds"], 3), "ptxas": v["ptxas"]}
               for k, v in report.items()})
    return report


def phase_kernels(g, device) -> dict:
    """bucket_hop vs bucket_hop_plain: random buckets, then one full hop
    of the bench graph at W = 128. Returns the per-hop timing record."""
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import bucket_hop, bucket_hop_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    err = 0
    cases = 0
    rows = 100_003
    for W in (1, 2, 128):
        fr = random_frontier(rows, W, gen, device)
        for K in (1, 3, 8, 32, 1024):
            for n_b in ((1, 37, 3001) if K < 1024 else (1, 517)):
                nbr = torch.randint(0, rows + 1, (n_b, K), generator=gen,
                                    dtype=torch.int64,
                                    device=device).to(torch.int32)
                nbr[:, -1] = rows            # every row touches the sentinel
                out = torch.full((n_b + 3, W), -1, dtype=torch.int32,
                                 device=device)
                bucket_hop(nbr, fr, out, row0=2)
                want = bucket_hop_plain(nbr, fr)
                torch.cuda.synchronize()
                e = max(max_abs_err(out[2:2 + n_b], want),
                        int((out[:2] != -1).sum()), int((out[2 + n_b:] != -1).sum()))
                if e:
                    raise AssertionError(f"bucket_hop != plain at K={K} "
                                         f"W={W} n_b={n_b}: err {e}")
                err = max(err, e)
                cases += 1
    empty = torch.zeros((0, 4), dtype=torch.int32, device=device)
    bucket_hop(empty, random_frontier(10, 4, gen, device))

    # one full hop of the bench graph at 4096 lanes, kernel vs plain
    W = LANES // 32
    prep = bfs.prepare_parts(bfs.device_ell(g, device))
    fr = random_frontier(g.n, W, gen, device, density=0.25)
    got = bfs._ell_hop(prep, fr)
    want = bfs._ell_hop(prep, fr, hop=bucket_hop_plain)
    torch.cuda.synchronize()
    hop_err = max_abs_err(got, want)
    if hop_err:
        raise AssertionError(f"full ELL hop: kernel != plain, err {hop_err}")
    ms = cuda_ms(lambda _: bfs._ell_hop(prep, fr), REPS)
    plain_ms = cuda_ms(lambda _: bfs._ell_hop(prep, fr,
                                              hop=bucket_hop_plain), 3)
    idx_bytes = 4 * (g.padded_edges + sum(int(t.size) for t in g.lvl2))
    mask_bytes = 4 * (g.n + 1) * W
    # least bytes one hop must move: every index once, the frontier once,
    # the next mask once (tile partials are internal); one OR per slot
    # and lane word
    bytes_ms = (idx_bytes + 2 * mask_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = idx_bytes // 4 * W / ALU_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # the gather model (bench.py): one mask row per level-1 slot
    gather_ms = g.padded_edges * (4 + 4 * W) / HBM_BYTES_PER_S * 1e3
    rec = {"ms": float(np.median(ms)), "plain_ms": float(np.median(plain_ms)),
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "max_abs_err": max(err, hop_err)}
    say("phase 3 kernels", cases=cases, random_max_abs_err=err,
        hop_max_abs_err=hop_err, hop_lanes=LANES, hop_ms=ms,
        hop_plain_ms=plain_ms, hop_bound_ms=bound_ms,
        hop_bytes_ms=bytes_ms, hop_ops_ms=ops_ms,
        hop_gather_model_ms=gather_ms,
        launches_per_hop=sum(1 for p in prep["parts"] if p[0] == "hop")
        + (1 + len(prep["lvl2"]) if prep["tiles"] is not None else 0))
    return rec


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
                check_lanes: int) -> dict:
    from dgraph_tpu_torch.engine.batch import _dev_for
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.bucket_hop import LAUNCHES

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
    total = int(edges.sum())
    row_bytes = 4 * W
    bytes_per_run = depth * (g.padded_edges * (4 + row_bytes)
                             + 4 * (g.n + 1) * row_bytes)
    say("phase 5 bench", lanes=lanes, depth=depth, run_ms=ms,
        median_ms=run_ms, total_edges=total,
        edges_per_s=total / (run_ms / 1e3),
        bound_ms=bytes_per_run / HBM_BYTES_PER_S * 1e3,
        model_bytes_per_run=bytes_per_run,
        model_gb_per_s=bytes_per_run / (run_ms / 1e3) / 1e9,
        padded_edges=g.padded_edges, launches_per_run=launches,
        kernel_share=share, checked_lanes=len(check))
    del out
    return {"run_ms": run_ms, "launches": launches}


def kernel_share(run):
    """Device time of one run by kernel, from torch.profiler: the
    bucket_hop kernels' microseconds, all kernels' microseconds, and the
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"bucket_hop_us": hop, "device_us": total, "wall_us": wall_us,
            "device_busy_share": total / wall_us,
            "share_of_device_time": hop / total,
            "top_kernels_us": {name[:80]: us for name, us in top}}


def main() -> None:
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
    hop = phase_kernels(g, device)
    launches = phase_serve(store, device, N_NODES, SERVE_QUERIES,
                           SERVE_DEPTH)
    phase_bench(store, device, N_NODES, LANES, DEPTH, CHECK_LANES)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": KERNEL_REPLACES[name],
                "launches": launches[name],
                "max_abs_err": hop["max_abs_err"], "ms": hop["ms"],
                "plain_ms": hop["plain_ms"], "bound_ms": hop["bound_ms"],
                "bound_by": hop["bound_by"], "library_ms": None}
               for name, src in KERNEL_SOURCES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
