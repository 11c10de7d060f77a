"""The port's flight recorder against the reference's.

`tests/test_flightrec.py`'s cases run through the lifecycle harness
(`test_torch_lifecycle.run_reference_case`): first with every
`dgraph_tpu.*` name bound to the port's (`utils/flightrec.py`, the
port's Alpha on the CPU, its admission controller and telemetry
pusher), then with the reference's own. Both packages' recorders, cost
priors and cost profiles are reset around each run, as the reference
file's own autouse fixture does. A case with a watchdog thread or a
signal is timing-shaped, so only its own assertions hold; the others'
transcripts must be equal. `test_http_acceptance_stalled_query_dumps_
and_diagnose_pulls`, whose last step runs the CLI (`cli.main(["diagnose",
...])`), runs in `test_torch_cli.py`. Left out:
`test_armed_overhead_under_5_percent`, a wall-clock ratio of
an Alpha on the CPU that the suite's six workers make noisy; the port's
armed-versus-disarmed p50 is measured on the card (`chip_smoke.py`
phase 16 (a)), as for the tracing guard (`test_torch_tracing.py`).

The port's own checks below: a watchdog dump that asks for a capture of
the card returns while another thread holds `DEVICE_WIDE` (the bundle
records the busy card), and the bundle's `memory` surface is the port's
governor.
"""

import threading
import time

import pytest

import dgraph_tpu.utils.costprior as ref_costprior
import dgraph_tpu.utils.costprofile as ref_costprofile
import dgraph_tpu.utils.flightrec as ref_flightrec
import test_flightrec
from dgraph_tpu_torch.utils import costprior, costprofile, flightrec, tracing
from dgraph_tpu_torch.utils.device import DEVICE_WIDE
from test_torch_lifecycle import PORT, REF, reference_cases, run_reference_case

CASES = reference_cases(test_flightrec,
                        skip={"test_armed_overhead_under_5_percent"})
# a watchdog thread or a signal decides when these cases' events land
NONDET = {"test_stalled_request_triggers_exactly_one_dump",
          "test_second_conviction_inside_interval_is_suppressed",
          "test_deadline_requests_judged_only_against_their_budget",
          "test_explicit_budget_track_convicts_like_bench_stage",
          "test_queue_head_stall_convicts", "test_wedged_pusher_convicts",
          "test_sigusr2_dumps_a_bundle"}


def reset_flight_state():
    """Both packages' recorder disarmed with no dump records, and their
    priors and cost profiles empty and on (the reference file's own
    autouse fixture, applied to each package)."""
    for fr, prior, prof in ((flightrec, costprior, costprofile),
                            (ref_flightrec, ref_costprior,
                             ref_costprofile)):
        fr.disarm()
        with fr._DUMPS_LOCK:
            del fr._DUMPS[:]
        prior.reset()
        prior.set_enabled(True)
        prof.reset()
        prof.set_enabled(True)


@pytest.fixture(autouse=True)
def _clean():
    reset_flight_state()
    yield
    reset_flight_state()


@pytest.mark.parametrize("name", CASES)
def test_flightrec_case_on_port(name, tmp_path, monkeypatch):
    port = run_reference_case(test_flightrec, name, PORT,
                              tmp_path / "port", monkeypatch)
    reset_flight_state()
    ref = run_reference_case(test_flightrec, name, REF, tmp_path / "ref",
                             monkeypatch)
    if name not in NONDET:
        assert port == ref


# -- the port's own ----------------------------------------------------------------

def test_watchdog_dump_returns_while_the_card_lock_is_held(tmp_path):
    """A conviction whose dump asks for a device capture must not wait
    on `DEVICE_WIDE`: with another thread holding it (as a CUDA-graph
    capture does), the dump is written within the capture timeout and
    its `device_profile` records the busy card."""
    tracing.enable_device_trace(str(tmp_path / "prof"))
    held, release = threading.Event(), threading.Event()

    def holder():
        with DEVICE_WIDE:
            held.set()
            release.wait(30)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert held.wait(5)
        flightrec.arm(diag_dir=str(tmp_path), poll_s=0.02, grace_s=0.02,
                      min_dump_interval_s=60.0, capture_device=True)
        t0 = time.monotonic()
        with flightrec.track("stage", budget_s=0.01):
            end = time.monotonic() + 10
            while not flightrec.dumps() and time.monotonic() < end:
                time.sleep(0.01)
        took = time.monotonic() - t0
        (rec,) = flightrec.dumps()
        assert rec["reason"]["kind"] == "wedged"
        assert took < flightrec.CAPTURE_WAIT_S + 5.0
        import json
        bundle = json.loads(open(rec["path"]).read())
        prof = bundle["device_profile"]
        assert "busy" in prof["error"] and "DEVICE_WIDE" in prof["error"]
        assert not tracing.profile_status()["running"]
    finally:
        release.set()
        t.join()
        tracing.enable_device_trace(None)


def test_watchdog_capture_lists_the_trace_when_the_card_is_free(tmp_path):
    """With `DEVICE_WIDE` free, the conviction's capture writes a
    torch.profiler trace and the bundle names it (on the CPU the trace
    holds no kernels)."""
    tracing.enable_device_trace(str(tmp_path / "prof"))
    try:
        flightrec.arm(diag_dir=str(tmp_path), poll_s=0.02, grace_s=0.02,
                      min_dump_interval_s=60.0, capture_device=True)
        with flightrec.track("stage", budget_s=0.01):
            end = time.monotonic() + 20
            while not flightrec.dumps() and time.monotonic() < end:
                time.sleep(0.01)
        (rec,) = flightrec.dumps()
        import json
        bundle = json.loads(open(rec["path"]).read())
        prof = bundle["device_profile"]
        assert "error" not in prof, prof
        assert prof["trace"].startswith(prof["dir"])
        assert isinstance(prof["kernels"], list)
    finally:
        tracing.enable_device_trace(None)


def test_bundle_memory_surface_is_the_ports_governor():
    """The bundle's `memory` surface is the port's governor status,
    whose inventory governs the time-series ring."""
    from dgraph_tpu_torch.utils import memgov
    out = flightrec.dump(trigger="manual")
    mem = out["bundle"]["surfaces"]["memory"]
    assert set(mem) == set(memgov.GOVERNOR.status())
    assert "timeseries.ring" in memgov.GOVERNED_CACHES
