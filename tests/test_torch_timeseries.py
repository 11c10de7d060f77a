"""The port's metrics history, SLO engine and forecast shedding against
the reference's.

`tests/test_timeseries.py`'s cases run through the lifecycle harness
(`test_torch_lifecycle.run_reference_case`): first with every
`dgraph_tpu.*` name bound to the port's (`utils/{timeseries,slo,
flightrec}.py`, its metrics `Registry`, admission controller, HTTP
server, fleet snapshot, and its Alpha and Engine on the CPU), then with
the reference's own. Both packages' sampler, SLO engine and recorder
are disarmed around each run, as the reference file's own autouse
fixture does. The cases that serve HTTP or run the sampler's thread are
timing-shaped (trace ids, clocks), so only their own assertions hold;
the others' transcripts must be equal. Left out: `test_bench_compare_
gate`, which drives the analysis CLI and runs on the port in
`test_torch_lint.py` with the reference's other analyzer cases, and
`test_armed_sampler_overhead_
under_5_percent`, a wall-clock ratio of an engine on the CPU that the
suite's six workers make noisy; the port's armed-versus-disarmed cost
is measured on the card (`chip_smoke.py` phase 16 (a)), as for the
tracing guard (`test_torch_tracing.py`).
"""

import pytest

import dgraph_tpu.utils.flightrec as ref_flightrec
import dgraph_tpu.utils.slo as ref_slo
import dgraph_tpu.utils.timeseries as ref_timeseries
import test_timeseries
from dgraph_tpu_torch.utils import flightrec, memgov, slo, timeseries
from test_torch_lifecycle import PORT, REF, reference_cases, run_reference_case

CASES = reference_cases(test_timeseries, skip={
    "test_bench_compare_gate", "test_armed_sampler_overhead_under_5_percent"})
NONDET = {"test_explain_echoes_cost_breakdown",
          "test_query_errors_counted_per_lane_any_transport",
          "test_breach_exemplar_and_debug_surfaces_live"}


def reset_series_state():
    for ts, eng, fr in ((timeseries, slo, flightrec),
                        (ref_timeseries, ref_slo, ref_flightrec)):
        ts.disarm()
        eng.uninstall()
        fr.disarm()


@pytest.fixture(autouse=True)
def _clean():
    reset_series_state()
    yield
    reset_series_state()


@pytest.mark.parametrize("name", CASES)
def test_timeseries_case_on_port(name, tmp_path, monkeypatch):
    port = run_reference_case(test_timeseries, name, PORT,
                              tmp_path / "port", monkeypatch)
    reset_series_state()
    ref = run_reference_case(test_timeseries, name, REF, tmp_path / "ref",
                             monkeypatch)
    if name not in NONDET:
        assert port == ref


# -- the port's own ----------------------------------------------------------------

def test_ring_is_a_governed_host_cache():
    """`timeseries.ring` is in the governor's inventory and a live ring
    registers under it, host kind, and surrenders its oldest points
    under the governor's eviction."""
    from dgraph_tpu_torch.utils.metrics import Registry
    assert "timeseries.ring" in memgov.GOVERNED_CACHES
    reg = Registry()
    ring = timeseries.Ring(points=64, registry=reg)
    assert "timeseries.ring" in memgov.GOVERNOR.registered_names()
    for t in range(10):
        reg.inc("x_total")
        ring.sample(now=float(t))
    assert len(ring) == 9
    doc = memgov.GOVERNOR.status()["caches"]["timeseries.ring"]
    assert doc["kind"] == "host" and doc["bytes"] > 0
    freed = ring._evict_one()
    assert freed > 0 and len(ring) == 9 - max(1, 64 // 16)


def test_sampler_and_watchdog_take_no_card_call(monkeypatch):
    """A sampler tick and a watchdog scan never synchronize the card:
    `torch.cuda.synchronize` raising here would fail them."""
    import torch

    def refuse(*a, **kw):
        raise AssertionError("the sampler or watchdog waited on the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    s = timeseries.arm(interval_s=60.0, ring_points=16,
                       slo_engine=slo.SloEngine(fast_window_s=5.0,
                                                slow_window_s=10.0),
                       start_thread=False)
    s.tick(now=1.0)
    s.tick(now=2.0)
    st = flightrec.arm(watchdog=False)
    from dgraph_tpu_torch.utils.flightrec import Watchdog
    wd = Watchdog(poll_s=1.0, stall_factor=2.0, stall_floor_ms=1.0,
                  grace_s=0.1, min_dump_interval_s=60.0,
                  maintenance_stall_s=60.0)
    wd._tick()
    assert st.ring.stats()["added"] >= 0
