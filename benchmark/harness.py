"""What every cell shares: the manifest, the device check, the traced
window and its reduction, the per-layer readers, and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "dgraph_tpu")
TOP_OPS = 10


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(candidates: bool = False) -> dict:
    """BENCHMARK.json; with `candidates`, also the entries of each
    `candidates/<cell>.json`: a cell built and proven correct that
    BENCHMARK.json does not hold yet (its tests and controls run it)."""
    man = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if candidates:
        folder = os.path.join(BENCH, "candidates")
        for name in sorted(os.listdir(folder)):
            extra = load_json(os.path.join(folder, name))
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                man[key] = man[key] + extra[key]
    return man


def cell_of(man: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration file, traffic file) of a workload name."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, cfg, traffic


def reported(man: dict, workload: str, section: str) -> list[dict]:
    """The metrics of `section` this cell reports: those that list it,
    and those without a list whose `moves` metric it reports."""
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def read_metric(name: str, ctx: dict):
    """The per-layer reader `metrics/<name>.py`: its `read(ctx)`, or
    None when it finds nothing to read."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Tracer:
    """torch.profiler over a traced window; what it leaves for the
    readers: device intervals by name, busy and window seconds, the
    idle gaps named by the host range open across them."""

    def __init__(self, enabled: bool, device: str):
        self.enabled = enabled
        self.cuda = device.startswith("cuda")
        # a driver whose host work runs on other threads names the idle
        # gaps by the program's spans (`finish(spans=...)`); its CPU
        # events are not recorded, which keeps the trace small
        self.host_events = True
        self._profs: list = []
        self.window_s = 0.0
        self.busy_s = 0.0
        self.device_ops: dict = {}
        self.device_events: list = []
        self.idle_gaps: dict = {}

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host_events else []
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts or [ProfilerActivity.CPU])

    def prime(self) -> None:
        """One throwaway session in set-up: the profiler's first start
        initialises the device tracing, which takes seconds."""
        if not self.enabled:
            return
        import torch
        with self._profile():
            if self.cuda:
                torch.zeros(1, device="cuda")
                torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        """Trace the body; the events are reduced in `finish`, after the
        run's window."""
        if not self.enabled:
            yield
            return
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        prof = self._profile()
        prof.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            self.window_s += time.perf_counter() - t0
            prof.__exit__(None, None, None)
            self._profs.append(prof)

    def finish(self, spans: list | None = None) -> None:
        """Reduce the traced sessions; `spans` (name, start, end in
        epoch seconds) name the idle gaps where no host events were
        recorded."""
        for prof in self._profs:
            self._collect(prof, spans)
        self._profs = []

    def _collect(self, prof, spans) -> None:
        from torch.autograd import DeviceType

        dev, cpu = [], []
        for ev in prof.events():
            tr = ev.time_range
            if getattr(ev, "is_user_annotation", False) and \
                    ev.device_type == DeviceType.CUDA:
                continue      # a host range mirrored on the device's row
            if ev.device_type == DeviceType.CUDA:
                dev.append((ev.name, tr.start, tr.end))
            else:
                cpu.append((ev.name, tr.start, tr.end))
        self.device_events += dev
        for name, a, b in dev:
            key = name[:80]
            self.device_ops[key] = self.device_ops.get(key, 0.0) + (
                b - a) / 1e6
        busy = _merge([[a, b] for _n, a, b in dev])
        self.busy_s += sum(b - a for a, b in busy) / 1e6
        if spans and busy:
            lo, hi = busy[0][0], busy[-1][1]
            by_span = _span_labeler(prof, spans)

            def label(t):
                name = by_span(t)
                return name if name != "host" or not cpu else \
                    _host_label(cpu, t)
        elif cpu:
            lo = min(a for _n, a, _b in cpu)
            hi = max(b for _n, _a, b in cpu)

            def label(t):
                return _host_label(cpu, t)
        else:
            return
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                name = label((a + b) / 2)
                self.idle_gaps[name] = self.idle_gaps.get(name, 0.0) + (
                    b - a) / 1e6

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])][:TOP_OPS]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.idle_gaps)}


def _host_label(cpu: list, t: float) -> str:
    """The outermost benchmark or program range open at `t` and the
    innermost operation inside it, or "host"."""
    open_ = [(a, -(b - a), name) for name, a, b in cpu if a <= t <= b]
    if not open_:
        return "host"
    open_.sort()
    outer = next((n for _a, _d, n in open_
                  if n.startswith(("bench.", "engine."))), None)
    inner = open_[-1][2]
    if outer is None or outer == inner:
        return (outer or inner)[:80]
    return f"{outer} > {inner}"[:80]


def _span_labeler(prof, spans: list):
    """t (µs into the trace) -> the program span most threads have open
    then, through the trace's epoch start; "host" where none is."""
    import collections
    try:
        t0 = prof.profiler.kineto_results.trace_start_ns() / 1e9
    except AttributeError:
        return lambda t: "host"

    def label(t):
        at = t0 + t / 1e6
        open_ = collections.Counter(n for n, a, b in spans if a <= at <= b)
        return open_.most_common(1)[0][0] if open_ else "host"
    return label


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown: dict | None, checks: dict) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
