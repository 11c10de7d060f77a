"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for sm_90a into `dgraph_tpu_torch/build/lib<name>-<hash>.so` at first use
(the hash is of the source and flags, so an edited source rebuilds), then
loaded with ctypes. The build directory is listed in `.gitignore`.
`build_all` starts one `nvcc` per source at once and waits for all of
them, and counts each build in `kernel_builds_total{kernel=,outcome=}`
and its time as the compile µs of kernel family `nvcc:<name>` in the
request's cost record (utils/costprofile.py); nothing here runs at
import time. A failed build raises: it is never taken for an allocation
failure (utils/memgov.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from dgraph_tpu_torch.utils import costprofile
from dgraph_tpu_torch.utils.metrics import METRICS
from dgraph_tpu_torch.utils import locks

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("bucket_hop", "segment_combine")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lock = locks.make_lock("kbuild.build")
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from csrc/ at first use")


def lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every named source that has no library yet, all `nvcc`s
    in parallel. Returns {name: {"seconds", "ptxas"}} for the ones built
    (ptxas: the compiler's register/shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (p, tmp, out, t0) in procs.items():
        try:
            log, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        if p.returncode != 0:
            METRICS.inc("kernel_builds_total", kernel=name, outcome="error")
            failed.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        METRICS.inc("kernel_builds_total", kernel=name, outcome="ok")
        # the build's time is this kernel family's compile µs in the
        # request's cost record (utils/costprofile.py), when one is open
        costprofile.add_kernel(f"nvcc:{name}",
                               compile_us=(time.perf_counter() - t0) * 1e6)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": "\n".join(l for l in log.splitlines()
                                           if "ptxas" in l)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(lib_path(name))
        return lib
