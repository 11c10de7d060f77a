"""segment_combine's long path under other compile-time constants.

    python3 -m dgraph_tpu_torch.tools.combine_variants [--out FILE]

Compiles `csrc/segment_combine.cu` once per variant with some of its
constants replaced (column tile, stage size, ring depth, slack, threads
per row, producer warps), every `nvcc` at once, into
`dgraph_tpu_torch/build/variants/`. Each variant's kernels
(`ops/feat.Prepared(...).launch()` with the wrapper's plan constants set
to match) are first held bit-equal to `engine/feat.host_combine`, then
timed by CUDA events (median of 7, twice) at two sorted shapes over a
random N(0,1) tablet of 1,009,892 x 384 rows (the GraphRAG tablet's
size): one 206,321-edge segment (msgpass_hub's) and eight of 25,000
edges. Needs one CUDA card; prints one JSON object per variant (and all
of them to --out when given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from dgraph_tpu_torch.engine.feat import host_combine
from dgraph_tpu_torch.ops import feat
from dgraph_tpu_torch.utils import kbuild

ROWS, DIM = 1_009_892, 384
HUB_EDGES = 206_321
HUBS, HUB_EACH = 8, 25_000
SEED = 1
REPS = 7
# name -> {constant: value}; "committed" is the source as it stands
VARIANTS = {
    "committed": {},
    "tile32": {"kTileCols": 32},
    "tile16": {"kTileCols": 16},
    "tile4": {"kTileCols": 4, "kRowShare": 1},
    "share1": {"kRowShare": 1},
    "producers64": {"kProducers": 64, "kCombineThreads": 96},
    "stages7": {"kStages": 7},
    "slack1": {"kSlack": 1},
    "stage8k": {"kStageFloats": 8192},
}


def build(names) -> dict:
    """{variant: library path}, all nvcc's started together."""
    src = open(os.path.join(kbuild.CSRC_DIR, "segment_combine.cu")).read()
    out_dir = os.path.join(kbuild.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for const, value in VARIANTS[name].items():
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                raise ValueError(f"{const} is not a constant of the source")
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, failed = {}, []
    for name, (p, so) in procs.items():
        log, _ = p.communicate(timeout=kbuild.BUILD_TIMEOUT_S)
        if p.returncode:
            failed.append(f"{name}: nvcc exited {p.returncode}\n{log}")
        libs[name] = so
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def use(name: str, so: str) -> None:
    """Point ops/feat at variant `name`'s library and plan."""
    lib = ctypes.CDLL(so)
    cfg = (ctypes.c_int32 * 7)()
    lib.dg_segment_combine_config(cfg)
    (_t, feat.COMBINE_THREADS, _l, feat.TILE_COLS, feat.STAGE_ROWS,
     feat.STAGES, feat.SMEM_BYTES) = tuple(cfg)
    feat.launch_plan.cache_clear()
    f = lib.dg_segment_combine
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    f.argtypes = [P, I64, P, I64, I32, P, P, P, I64, P, I32, I32, I32, P,
                  I32, I32, P, P, P, P]
    f.restype = ctypes.c_int
    lib.dg_error_string.argtypes = [ctypes.c_int]
    lib.dg_error_string.restype = ctypes.c_char_p
    if lib.dg_segment_combine_init():
        raise RuntimeError(f"{name}: init failed")
    feat._fn = (f, lib.dg_error_string)


def cuda_ms(fn) -> float:
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return float(np.median(out))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    libs = build(names)
    dev = "cuda"
    rng = np.random.default_rng(SEED)
    subj_h = np.arange(0, 2 * ROWS, 2, dtype=np.int32)
    vecs_h = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    subj, vecs = torch.from_numpy(subj_h).to(dev), torch.from_numpy(
        vecs_h).to(dev)
    hub = 2 * rng.choice(ROWS, HUB_EDGES, replace=False).astype(np.int32)
    hubs = 2 * rng.integers(0, ROWS, HUBS * HUB_EACH).astype(np.int32)
    shapes = {"hub": (hub, np.zeros(HUB_EDGES, np.int32), 1),
              "8_hubs": (hubs, np.repeat(np.arange(HUBS, dtype=np.int32),
                                         HUB_EACH), HUBS)}
    want = {k: host_combine(subj_h, vecs_h, nb, sg, n, "sum")
            for k, (nb, sg, n) in shapes.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rows = []
    for name in names:
        use(name, libs[name])
        row = {"variant": name, "constants": VARIANTS[name], "card": smi}
        for shape, (nb, sg, n) in shapes.items():
            call = feat.Prepared(subj, vecs, torch.from_numpy(nb).to(dev),
                                 torch.from_numpy(sg).to(dev), len(nb), n,
                                 "sum", True)
            call.launch()
            torch.cuda.synchronize()
            equal = all(np.array_equal(g.cpu().numpy().view(np.int32),
                                       w.view(np.int32))
                        for g, w in zip(call.outputs, want[shape]))
            if not equal:
                raise AssertionError(f"{name} at {shape}: differs from "
                                     f"host_combine")
            row[f"{shape}_ms"] = [cuda_ms(call.launch) for _ in range(2)]
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
