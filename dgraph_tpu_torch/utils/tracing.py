"""Tracing: per-request trace ids, per-hop spans + device profiling.

Port of `dgraph_tpu/utils/tracing.py`. Reference parity: OpenCensus
spans around each `ProcessTaskOverNetwork` leg with Jaeger export
(SURVEY §5). Lightweight in-process spans (a queryable ring buffer + a
per-trace index, Chrome trace-event and OTLP/JSON export) and
`torch.profiler` capture for device timelines where the reference takes
`jax.profiler`:

* every span also opens a `torch.profiler.record_function` range of the
  same name, so a device profile shows the serving stages (`engine.parse`,
  `batch.tree_run`, `maintenance.job`, ...) around their kernels. The
  range opens even while span recording is disabled, so a profile keeps
  its names either way;
* `span(..., device=True)` fences with `torch.cuda.synchronize()` where
  the reference calls `jax.effects_barrier()`, so its duration covers
  the device work it queued;
* `profile_start` / `profile_stop` write a Chrome trace
  (`trace-<stamp>.json`) under the capture dir. A torch.profiler
  session must start and stop on one thread, and the HTTP front end
  calls the two from different request threads: both run on one
  long-lived profiler thread (`_on_profiler_thread`), and the session
  records the CPU ranges of every thread where the installed torch
  offers it (`profile_all_threads`); the card's kernels are recorded
  device-wide either way.

Identity model: every span gets a process-unique integer `span_id`;
nesting is a thread-local STACK of span ids, so concurrent (or nested)
spans that share a name can never alias each other. A span belongs to
the trace id established by the enclosing `trace()` context (one per
request on the serving path); spans opened outside any trace carry
trace_id "" and only live in the ring buffer.

`set_enabled(False)` turns span recording into a near-no-op: one flag
check and the profiler range.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function
from dgraph_tpu_torch.utils import locks

_TRACE_DIR: str | None = None
_BUF: deque = deque(maxlen=4096)
_TRACES: "OrderedDict[str, list]" = OrderedDict()
_MAX_TRACES = 256          # retained per-trace span lists
_MAX_TRACE_SPANS = 4096    # spans retained per trace
_LOCK = locks.make_lock("tracing.registry")
_TLS = threading.local()
# span ids must stay unique when spans from SEVERAL processes merge into
# one trace (cross-process propagation, /debug/fleet): the counter is
# salted with the pid in the high bits, so a worker span's parent_id
# (a coordinator-issued id forwarded over gRPC metadata) can never
# collide with a locally-issued id. CPython: count.__next__ is atomic.
_PID = os.getpid()
_IDS = itertools.count(((_PID & 0xFFFF) << 40) | 1)
_ENABLED = True
_SINKS: list = []          # live-export subscribers (utils/push.py)
# cross-process trace-health counters (the bench "fleet" block):
# spans recorded, and spans recorded under a PROPAGATED (attach'd)
# trace context — both under _LOCK with the registries
_STAT = {"spans": 0, "propagated": 0}
_NAMES: set = set()        # every span name recorded in this process


@dataclass
class Span:
    name: str
    span_id: int = 0
    parent_id: int = 0          # 0 = root of its thread's stack
    trace_id: str = ""          # "" = outside any trace() context
    start_us: int = 0           # wall-clock epoch µs (Chrome `ts`)
    dur_us: int = 0
    tid: int = 0                # OS thread id (Chrome track)
    pid: int = 0                # OS process id (Chrome process row)
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "trace_id": self.trace_id,
                "start_us": self.start_us, "dur_us": self.dur_us,
                "tid": self.tid, "pid": self.pid,
                "attrs": dict(self.attrs)}


# reused sink for disabled spans: callers may still write attrs into it
_NULL_SPAN = Span(name="")


def set_enabled(flag: bool) -> None:
    """Globally arm/disarm span recording (metrics have their own
    switch). Disabled spans cost one attribute load per enter/exit."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def enable_device_trace(trace_dir: str) -> None:
    """Arm torch.profiler capture for the next `span(..., device=True)`."""
    global _TRACE_DIR
    _TRACE_DIR = trace_dir


# -- on-demand device profiling -----------------------------------------------
# a torch.profiler capture is process-global in effect (one CUPTI
# session): start/stop are single-flight behind a lock, so two callers
# can never run two captures at once.
_PROFILE_LOCK = locks.make_lock("tracing.profile")
_PROFILE_DIR: str | None = None
_PROFILER = None


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _new_profiler():
    """A torch.profiler session over every thread's CPU ranges where
    the installed torch has the option, else the starting thread's."""
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    return torch.profiler.profile(activities=_activities(), **kw)


_PROF_THREAD = None     # the one thread every session starts and stops on
_PROF_CALLS = None


def _on_profiler_thread(fn):
    """Run `fn()` on the profiler thread (started at first use) and
    return its result, or raise its error, here."""
    global _PROF_THREAD, _PROF_CALLS
    import queue
    if _PROF_THREAD is None:
        _PROF_CALLS = queue.Queue()

        def loop(calls=_PROF_CALLS):
            while True:
                f, box, done = calls.get()
                try:
                    box.append((True, f()))
                except BaseException as e:  # noqa: BLE001 — handed back
                    box.append((False, e))
                done.set()

        _PROF_THREAD = threading.Thread(target=loop, daemon=True,
                                        name="dgraph-profiler")
        _PROF_THREAD.start()
    box, done = [], threading.Event()
    _PROF_CALLS.put((fn, box, done))
    done.wait()
    ok, val = box[0]
    if not ok:
        raise val
    return val


def _trace_path(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(d, f"trace-{stamp}-{_PID}-{next(_IDS) & 0xFFFFFF}"
                           f".json")


class CardBusy(RuntimeError):
    """`DEVICE_WIDE` stayed held past the caller's timeout."""


@contextlib.contextmanager
def _device_wide(timeout_s: float | None):
    """`DEVICE_WIDE`, waited for at most `timeout_s` (None: no limit)."""
    from dgraph_tpu_torch.utils.device import DEVICE_WIDE
    if not DEVICE_WIDE.acquire(timeout=-1 if timeout_s is None
                               else timeout_s):
        raise CardBusy(f"the card is busy: DEVICE_WIDE held for more "
                       f"than {timeout_s} s by another thread")
    try:
        yield
    finally:
        DEVICE_WIDE.release()


def profile_start(trace_dir: str | None = None,
                  wide_timeout_s: float | None = None) -> str:
    """Start a torch.profiler capture under `trace_dir` (default: the
    dir `enable_device_trace` armed). Raises when no dir is configured
    or a capture is already running (single-flight), and `CardBusy`
    when `DEVICE_WIDE` stays held past `wide_timeout_s`. Returns the
    capture dir."""
    from dgraph_tpu_torch.utils.metrics import METRICS
    global _PROFILE_DIR, _PROFILER
    d = trace_dir or _TRACE_DIR
    if not d:
        raise ValueError("no trace dir configured — arm one with "
                         "enable_device_trace or pass trace_dir")
    with _PROFILE_LOCK:
        if _PROFILE_DIR is not None:
            raise RuntimeError(
                f"a device profile is already capturing under "
                f"{_PROFILE_DIR} — stop it first (single-flight)")
        prof = _new_profiler()
        with _device_wide(wide_timeout_s):  # never while another captures
            _on_profiler_thread(prof.__enter__)
        _PROFILE_DIR, _PROFILER = d, prof
        METRICS.inc("device_profile_captures_total", outcome="started")
        return d


def profile_stop(wide_timeout_s: float | None = None) -> str:
    """Stop the running capture, write its Chrome trace
    (`<dir>/trace-<stamp>-<pid>-<n>.json`, Perfetto-loadable) and
    return the dir. On `CardBusy` the capture keeps running."""
    from dgraph_tpu_torch.utils.metrics import METRICS
    global _PROFILE_DIR, _PROFILER
    with _PROFILE_LOCK:
        if _PROFILE_DIR is None:
            raise RuntimeError("no device profile is running")
        d, prof = _PROFILE_DIR, _PROFILER
        try:
            with _device_wide(wide_timeout_s):
                _PROFILE_DIR = _PROFILER = None
                _on_profiler_thread(
                    lambda: prof.__exit__(None, None, None))
            prof.export_chrome_trace(_trace_path(d))
        except CardBusy:
            raise
        except Exception:
            METRICS.inc("device_profile_captures_total", outcome="error")
            raise
        METRICS.inc("device_profile_captures_total", outcome="ok")
        return d


def profile_status() -> dict:
    with _PROFILE_LOCK:
        return {"running": _PROFILE_DIR is not None,
                "dir": _PROFILE_DIR}


def _fence() -> None:
    """Wait for the device work queued so far (the port's
    `jax.effects_barrier`)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        from dgraph_tpu_torch.utils.device import DEVICE_WIDE
        with DEVICE_WIDE:     # never while another thread captures
            torch.cuda.synchronize()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace_id() -> str:
    return getattr(_TLS, "trace_id", "")


def current_span_id() -> int:
    """The innermost open span's id on this thread (0 = none) — what an
    outbound RPC forwards as the remote child's parent id."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else 0


@contextlib.contextmanager
def attach(trace_id: str, parent_id: int = 0):
    """Re-establish a PROPAGATED trace context on this thread: spans
    opened inside index under `trace_id`, and (when `parent_id` is
    given) parent to that FOREIGN span id — so a worker-side handler's
    spans become genuine children of the coordinator's request trace,
    and a maintenance job joins the admin request that triggered it.
    Empty `trace_id` is a no-op (the common un-traced RPC path)."""
    if not trace_id:
        yield
        return
    from dgraph_tpu_torch.utils.metrics import METRICS
    METRICS.inc("trace_propagated_total")
    prev = getattr(_TLS, "trace_id", "")
    _TLS.trace_id = trace_id
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    pushed = bool(parent_id)
    if pushed:
        stack.append(parent_id)
    _TLS.attach_depth = getattr(_TLS, "attach_depth", 0) + 1
    try:
        yield
    finally:
        _TLS.attach_depth -= 1
        if pushed:
            stack.pop()
        _TLS.trace_id = prev


@contextlib.contextmanager
def trace(name: str = "request", trace_id: str | None = None, **attrs):
    """Establish a trace context: every span opened on this thread while
    inside (the root `name` span included) is indexed under the yielded
    trace id — the id the serving path echoes to clients and
    `/debug/traces?trace_id=` resolves."""
    tid = trace_id or new_trace_id()
    prev = getattr(_TLS, "trace_id", "")
    _TLS.trace_id = tid
    try:
        with span(name, **attrs):
            yield tid
    finally:
        _TLS.trace_id = prev


@contextlib.contextmanager
def span(name: str, device: bool = False, **attrs):
    """Time a region; nests via a thread-local stack of span IDS (names
    never participate in parent tracking — same-name spans, nested or
    concurrent, stay distinct). Yields the Span so callers can attach
    attrs discovered mid-region (edge counts, chosen code path). The
    region is also a `record_function` range of the same name.

    `device=True` additionally wraps the region in a torch.profiler
    capture (if armed) and waits for the device work queued inside
    before closing the span.
    """
    if not _ENABLED and not device:
        with record_function(name):
            yield _NULL_SPAN
        return
    sid = next(_IDS)
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    s = Span(name=name, span_id=sid,
             parent_id=stack[-1] if stack else 0,
             trace_id=getattr(_TLS, "trace_id", ""),
             # graftlint: allow(wall-clock): span start is an EPOCH timestamp —
             # Perfetto/OTLP exports align traces across processes by wall clock
             start_us=int(time.time() * 1e6),
             tid=threading.get_ident(), pid=_PID, attrs=attrs)
    stack.append(sid)
    t0 = time.perf_counter()
    prof = None
    if device and _TRACE_DIR is not None:
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
    try:
        with record_function(name):
            yield s
    finally:
        if device:
            # fence pending async work so dur_us covers real execution
            _fence()
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(_trace_path(_TRACE_DIR))
        stack.pop()
        s.dur_us = int((time.perf_counter() - t0) * 1e6)
        propagated = getattr(_TLS, "attach_depth", 0) > 0
        with _LOCK:
            _STAT["spans"] += 1
            _NAMES.add(name)
            if propagated:
                _STAT["propagated"] += 1
            _BUF.append(s)
            if s.trace_id:
                spans = _TRACES.get(s.trace_id)
                if spans is None:
                    spans = _TRACES[s.trace_id] = []
                    while len(_TRACES) > _MAX_TRACES:
                        _TRACES.popitem(last=False)
                if len(spans) < _MAX_TRACE_SPANS:
                    spans.append(s)
        if _SINKS:
            # live push (outside the lock): sinks buffer-and-return —
            # the request path never blocks on a collector
            for sink in tuple(_SINKS):
                try:
                    sink(s)
                except Exception:  # noqa: BLE001 — a sink must never fail a span
                    pass


def add_sink(fn) -> None:
    """Subscribe to completed spans (the live push pipeline). Sinks run
    on the closing thread and must be non-blocking."""
    if fn not in _SINKS:
        _SINKS.append(fn)


def remove_sink(fn) -> None:
    with contextlib.suppress(ValueError):
        _SINKS.remove(fn)


def recent(n: int = 100) -> list[Span]:
    with _LOCK:
        return list(_BUF)[-n:]


def trace_spans(trace_id: str) -> list[Span]:
    """Completed spans of one trace, in completion order (children close
    before parents, so the root span is last)."""
    with _LOCK:
        return list(_TRACES.get(trace_id, ()))


def names() -> set:
    """Every span name recorded in this process so far."""
    with _LOCK:
        return set(_NAMES)


def stats() -> dict:
    """Cross-process trace health: spans recorded and the fraction
    recorded under a propagated (attach'd) trace context — the bench
    "fleet" block and the /debug/fleet per-node fragments read this."""
    with _LOCK:
        spans, prop = _STAT["spans"], _STAT["propagated"]
    return {"spans_total": spans, "propagated_total": prop,
            "propagated_frac": round(prop / spans, 4) if spans else 0.0}


def to_chrome(spans: list[Span]) -> dict:
    """Chrome trace-event JSON (the `ph:"X"` complete-event form) —
    loadable in Perfetto / chrome://tracing. Span attrs ride in `args`;
    ts/dur are µs as the format requires."""
    return {
        "displayTimeUnit": "ms",
        "traceEvents": [
            {"name": s.name, "cat": "dgraph_tpu", "ph": "X",
             "ts": s.start_us, "dur": max(s.dur_us, 1),
             # each originating process is its own Perfetto process row,
             # so a merged cross-process trace renders both sides on one
             # timeline (historical spans without a pid fold under 1)
             "pid": s.pid or 1, "tid": s.tid,
             "args": {**{k: _jsonable(v) for k, v in s.attrs.items()},
                      "span_id": s.span_id, "parent_id": s.parent_id,
                      "trace_id": s.trace_id}}
            for s in spans],
    }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# -- OTLP/JSON export (ROADMAP: span export to an external collector) --------

def _otlp_any(v) -> dict:
    """Python value → OTLP AnyValue (the typed union OTLP mandates)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # OTLP/JSON carries int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": v if isinstance(v, str) else str(v)}


def _from_otlp_any(d: dict):
    if "boolValue" in d:
        return bool(d["boolValue"])
    if "intValue" in d:
        return int(d["intValue"])
    if "doubleValue" in d:
        return float(d["doubleValue"])
    return d.get("stringValue", "")


def _otlp_trace_id(tid: str) -> str:
    """Our 16-hex trace ids → the 32-hex (16-byte) ids OTLP requires.
    Left-padded with zeros; non-hex ids (tests pass arbitrary strings)
    fall back to a hex encoding of the string bytes."""
    if not tid:
        return "0" * 32
    try:
        return f"{int(tid, 16):032x}"
    except ValueError:
        return tid.encode().hex()[:32].ljust(32, "0")


def to_otlp(spans: list[Span]) -> dict:
    """OTLP/JSON (`ExportTraceServiceRequest` shape) — POSTable to any
    collector's `/v1/traces` as-is. Span ids hex-encode to the 8-byte
    spanId field; nanosecond timestamps derive from start_us + dur_us;
    attrs become typed keyValue pairs. The raw registry identifiers
    also ride as `dgraph.*` attributes so `from_otlp` round-trips
    losslessly (the round-trip test pins this)."""
    out = []
    for s in spans:
        attrs = [{"key": k, "value": _otlp_any(_jsonable(v))}
                 for k, v in s.attrs.items()]
        attrs.append({"key": "dgraph.trace_id",
                      "value": {"stringValue": s.trace_id}})
        attrs.append({"key": "dgraph.tid",
                      "value": {"intValue": str(s.tid)}})
        attrs.append({"key": "dgraph.pid",
                      "value": {"intValue": str(s.pid)}})
        out.append({
            "traceId": _otlp_trace_id(s.trace_id),
            "spanId": f"{s.span_id:016x}",
            "parentSpanId": (f"{s.parent_id:016x}" if s.parent_id
                             else ""),
            "name": s.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(s.start_us * 1000),
            "endTimeUnixNano": str((s.start_us + s.dur_us) * 1000),
            "attributes": attrs,
        })
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": "dgraph_tpu"}}]},
        "scopeSpans": [{"scope": {"name": "dgraph_tpu"},
                        "spans": out}],
    }]}


def from_otlp(doc: dict) -> list[Span]:
    """Inverse of `to_otlp` (the round-trip contract): rebuild Span
    objects from an OTLP/JSON document."""
    spans = []
    for rs in doc.get("resourceSpans", ()):
        for ss in rs.get("scopeSpans", ()):
            for o in ss.get("spans", ()):
                attrs, tid, os_tid, os_pid = {}, "", 0, 0
                for kv in o.get("attributes", ()):
                    v = _from_otlp_any(kv.get("value", {}))
                    if kv["key"] == "dgraph.trace_id":
                        tid = v
                    elif kv["key"] == "dgraph.tid":
                        os_tid = int(v)
                    elif kv["key"] == "dgraph.pid":
                        os_pid = int(v)
                    else:
                        attrs[kv["key"]] = v
                start_us = int(o["startTimeUnixNano"]) // 1000
                spans.append(Span(
                    name=o["name"],
                    span_id=int(o["spanId"], 16),
                    parent_id=(int(o["parentSpanId"], 16)
                               if o.get("parentSpanId") else 0),
                    trace_id=tid,
                    start_us=start_us,
                    dur_us=int(o["endTimeUnixNano"]) // 1000 - start_us,
                    tid=os_tid, pid=os_pid, attrs=attrs))
    return spans


def export_otlp(path: str, spans: list[Span] | None = None) -> int:
    """Write the span registry (default: the full ring buffer) as
    OTLP/JSON to `path` — the `--trace_export` flag's shutdown hook and
    an offline bridge to collectors. Returns the span count."""
    import json
    if spans is None:
        spans = recent(len(_BUF))
    with open(path, "w") as f:
        json.dump(to_otlp(spans), f)
    return len(spans)


def clear() -> None:
    with _LOCK:
        _BUF.clear()
        _TRACES.clear()
        _STAT["spans"] = _STAT["propagated"] = 0
