"""The port's tracing against the reference's: span identity and nesting,
trace contexts, the ring buffer and per-trace index, Chrome-event and
OTLP export, the off switch, and the profiler ranges spans open.

`tests/test_tracing.py`'s cases run with the port's `tracing` bound in
(the harness of `test_torch_lifecycle.py`), then with the reference's.
Each run's transcript is the spans it left in the ring — names, attrs,
parent links as positions in the ring, whether a trace id was set —
and the two must be equal. Tolerance: exact.
"""

import json

import pytest
import torch

import dgraph_tpu.utils.tracing as ref_tracing
import test_tracing
from dgraph_tpu_torch.engine import Engine
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.utils import tracing
from test_torch_lifecycle import PORT, REF, run_reference_case

# the wall-clock overhead ratio is a CPU timing of the reference's
# engine; the port's overhead is measured on the card (chip_smoke.py
# phase 12 (e))
SKIP = {"test_query_path_overhead_under_5_percent"}
CASES = [n for n in vars(test_tracing)
         if n.startswith("test_") and n not in SKIP]
# two threads race to open their spans: the ring's order is theirs
NONDETERMINISTIC = {"test_concurrent_same_name_spans_keep_thread_local_parents"}


def _spans(mod):
    spans = mod.recent(100_000)
    pos = {s.span_id: i for i, s in enumerate(spans)}
    return [(s.name, json.dumps(s.attrs, sort_keys=True, default=str),
             pos.get(s.parent_id, -1 if s.parent_id else None),
             bool(s.trace_id), s.dur_us >= 0) for s in spans]


def _run(pkg, name, tmp, monkeypatch):
    mod = tracing if pkg == PORT else ref_tracing
    mod.clear()
    mod.set_enabled(True)
    out = []
    try:
        run_reference_case(test_tracing, name, pkg, tmp, monkeypatch,
                           after=lambda tr: out.extend(_spans(mod)))
    finally:
        mod.set_enabled(True)
        mod.clear()
    return out


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_port(name, tmp_path, monkeypatch):
    port = _run(PORT, name, tmp_path / "port", monkeypatch)
    ref = _run(REF, name, tmp_path / "ref", monkeypatch)
    if name not in NONDETERMINISTIC:
        assert port == ref


def test_spans_open_profiler_ranges_on_or_off():
    """A span is a `record_function` range of its name, recorded or
    not, so a device profile keeps the serving stages' names."""
    names = []
    for flag in (True, False):
        tracing.set_enabled(flag)
        with torch.profiler.profile() as prof:
            with tracing.span("outer.stage"):
                with tracing.span("inner.stage"):
                    torch.ones(4).sum()
        names.append({e.name for e in prof.events()})
    tracing.set_enabled(True)
    for got in names:
        assert {"outer.stage", "inner.stage"} <= got


def test_profile_capture_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    assert tracing.profile_start(d) == d
    with pytest.raises(RuntimeError):
        tracing.profile_start(d)        # single-flight
    with tracing.span("captured.stage"):
        torch.ones(8).sum()
    assert tracing.profile_status()["running"]
    assert tracing.profile_stop() == d
    assert not tracing.profile_status()["running"]
    with pytest.raises(RuntimeError):
        tracing.profile_stop()
    (path,) = list((tmp_path / "prof").iterdir())
    doc = json.loads(path.read_text())
    assert "captured.stage" in {e.get("name") for e in doc["traceEvents"]}


def test_engine_stages_are_spans_in_one_trace():
    b = StoreBuilder(parse_schema("f: [uid] ."))
    for i in range(1, 6):
        b.add_edge(i, "f", i + 1)
    eng = Engine(b.finalize(), device="cpu", device_threshold=0)
    tracing.clear()
    with tracing.trace("request") as tid:
        eng.query_bytes("{ q(func: uid(0x1)) { f { f { uid } } } }")
    names = [s.name for s in tracing.trace_spans(tid)]
    for n in ("engine.parse", "engine.block", "engine.query",
              "engine.render", "request"):
        assert n in names
    assert names[-1] == "request"
