"""The port's maintenance paths against the reference's: streamed rollup,
checkpoint, backup and export under a memory budget, and the background
scheduler (rollup-when-deep, periodic checkpoint, requested jobs, pause,
resume, retry, drain).

`tests/test_maintenance.py`'s cases run with the port's objects (the
harness of `test_torch_lifecycle.py`) and again with the reference's;
their transcripts must be equal, except where threads decide what a
transcript holds (the scheduler's concurrent readers and writer), where
each run's own assertions hold. Tolerance: exact.
"""

import threading
import time

import pytest

import test_maintenance
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store.maintenance import MaintenanceScheduler
from dgraph_tpu_torch.utils import tracing
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_lifecycle import compare_case, reference_cases

# the HTTP admin triggers run with the front end's cases
# (tests/test_torch_http.py)
SKIP = {"test_admin_http_triggers"}
# reader and writer threads interleave with the scheduler differently in
# each run
NONDETERMINISTIC = {"test_scheduler_rollup_checkpoint_while_serving"}

CASES = reference_cases(test_maintenance, SKIP)
_SEEDS: dict = {}     # (package, module, fixture) -> the seed checkpoint


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_port(name, tmp_path, monkeypatch,
                                tmp_path_factory):
    compare_case(test_maintenance, name, tmp_path, monkeypatch,
                 factory=tmp_path_factory, cache=_SEEDS,
                 nondeterministic=NONDETERMINISTIC)


def test_case_list_covers_the_issue():
    assert len(CASES) == 8 and \
        "test_streaming_maintenance_bit_identical_under_budget" in CASES


def _alpha(tmp_path, n=40):
    a = Alpha.open(str(tmp_path), device="cpu", sync=False)
    a.alter("name: string @index(exact) .\nfollows: [uid] @reverse .")
    a.mutate(set_nquads="\n".join(
        f'_:p{i} <name> "p{i}" .\n_:p{i} <follows> _:p{(i + 1) % n} .'
        for i in range(n)))
    return a


def test_jobs_emit_spans_and_counters_and_drain(tmp_path):
    """Requested backup and export jobs and a checkpoint run in the
    job's `maintenance.job` span with its tablets' `maintenance.tablet`
    spans under it; `shutdown` drains the queue before its checkpoint."""
    tracing.clear()
    a = _alpha(tmp_path / "p")
    a.checkpoint_to(str(tmp_path / "p"))
    sched = a.attach_maintenance(str(tmp_path / "p"))
    ok0 = METRICS.get("maintenance_jobs_total", job="export", outcome="ok")
    sched.pause()
    jobs = [sched.request_backup(str(tmp_path / "bk")),
            sched.request_export(str(tmp_path / "x.rdf")),
            sched.request_checkpoint()]
    time.sleep(0.1)
    assert sched.status()["queued"] and sched.paused
    sched.resume()
    a.shutdown(str(tmp_path / "p"))     # drains, then checkpoints
    assert all(j.done.is_set() and j.error is None for j in jobs)
    assert jobs[0].result["type"] == "full"
    assert jobs[1].result == 80
    assert METRICS.get("maintenance_jobs_total", job="export",
                       outcome="ok") == ok0 + 1
    spans = tracing.recent(4096)
    job_ids = {s.span_id: s.attrs["job"] for s in spans
               if s.name == "maintenance.job"}
    assert {"backup", "export", "checkpoint"} <= set(job_ids.values())
    tablets = [s for s in spans if s.name == "maintenance.tablet"
               and s.attrs.get("job") == "export"]
    assert tablets and all(job_ids.get(s.parent_id) == "export"
                           for s in tablets)
    assert not sched._thread.is_alive()


def test_pace_parks_a_streamed_job_between_tablets(tmp_path):
    """The pace hook blocks at a tablet boundary while paused, and the
    pause is counted and timed."""
    a = _alpha(tmp_path / "p")
    a.checkpoint_to(str(tmp_path / "p"))
    sched = MaintenanceScheduler(a, str(tmp_path / "p"), pacing_ms=0)
    p0 = METRICS.get("maintenance_pauses_total")
    sched.pause()
    done = threading.Event()

    def run():
        a.export_to(str(tmp_path / "x.rdf"), pace=sched._pace)
        done.set()
    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.2)
    assert not done.is_set()           # parked after the first tablet
    assert METRICS.get("maintenance_pauses_total") == p0 + 1
    sched.resume()
    t.join(10)
    assert done.is_set()
    assert sched.progress >= 2


def test_rollup_policy_reads_layers_above_the_fold(tmp_path):
    a = _alpha(tmp_path / "p")
    assert a.mvcc.pending_layer_count() == 1
    a.mutate(set_nquads='_:x <name> "x" .')
    assert a.mvcc.pending_layer_count() == 2
    a.maintenance_rollup()
    assert a.mvcc.pending_layer_count() == 0
    sched = MaintenanceScheduler(a, str(tmp_path / "p"), rollup_after=1)
    assert sched._due_policy_job() is None
    a.mutate(set_nquads='_:y <name> "y" .')
    assert sched._due_policy_job().name == "rollup"
