"""The port's cost profiles against the reference's.

`tests/test_costprofile.py`'s cases run with the port's objects bound in
(the harness of `test_torch_lifecycle.py`: `Digest`, `Aggregator`,
`FIELDS`, `COSTS`, the port's `Alpha` on the CPU), then with the
reference's; their transcripts (every `Alpha` answer) must be equal and
each run's own assertions hold. Tolerance: exact.

The reference's overhead guard is a wall-clock ratio; its port
counterpart counts the recorder's work instead (no record and no
recorder when profiling is off, one record per request when it is on).
The `/debug/costs` case and a counterpart of the `/debug/profile` case
run in `test_torch_http.py`. The telemetry pusher's cases
(`utils/push.py`) run here too.
"""

import pytest

import test_costprofile
from dgraph_tpu_torch.engine.batch import _plan_shape, plan_batch_groups_cached
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.utils import costprofile
from dgraph_tpu_torch.utils.costprofile import FIELDS
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_lifecycle import PORT, REF, run_reference_case
from test_torch_memgov import reset_cost_state


@pytest.fixture(autouse=True)
def _clean():
    reset_cost_state()
    yield
    reset_cost_state()


CASES = ["test_digest_merge_is_exact_and_associative",
         "test_digest_percentiles_bracket_the_data",
         "test_empty_digest_is_safe",
         "test_shape_cardinality_overflows_to_other",
         "test_persistence_round_trip_and_merge",
         "test_alpha_checkpoint_persists_and_reopen_merges",
         "test_records_speak_the_shared_vocabulary",
         "test_kernel_launch_count_and_dispatch_gap_attribution",
         "test_pusher_delivers_spans_and_costs_through_faults",
         "test_pusher_bounded_buffer_drops_are_counted_not_blocking"]


@pytest.mark.parametrize("name", CASES)
def test_costprofile_case_on_port(name, tmp_path, monkeypatch):
    port = run_reference_case(test_costprofile, name, PORT,
                              tmp_path / "port", monkeypatch)
    reset_cost_state()
    ref = run_reference_case(test_costprofile, name, REF, tmp_path / "ref",
                             monkeypatch)
    assert port == ref


def _alpha():
    a = Alpha(device="cpu", device_threshold=0)
    a.alter("friend: [uid] @reverse .\nname: string @index(exact) .")
    a.mutate(set_nquads="\n".join(
        f'<{i}> <name> "p{i}" .\n<{i}> <friend> <{i % 30 + 1}> .\n'
        f'<{i}> <friend> <{(7 * i) % 30 + 1}> .' for i in range(1, 31)))
    return a


BATCH = (["{ q(func: uid(%d)) @recurse(depth: 3) { friend uid } }" % i
          for i in range(1, 9)]
         + ['{ q(func: uid(%d)) { name friend { name friend { name } } } }'
            % i for i in range(1, 9)])


def test_batch_record_names_each_group_and_its_costs():
    """A served batch's record carries one shape component per group
    family, the groups' lanes, depth, padding and query counts, one
    launch per group, their execute µs per family and the plan memo's
    hit bit."""
    a = _alpha()
    a.query_batch(BATCH)
    rec = costprofile.recent(1)[0]
    assert set(rec) == set(FIELDS)
    assert "recurse:friend~d3" in rec["shape"]
    assert "tree:*~d" in rec["shape"]
    assert rec["kernel_launches"] == 2
    assert rec["lanes"] == 32 and rec["queries"] >= 16
    assert rec["padded_lanes"] == 2 * (32 - 8)
    assert set(rec["kernels"]) == {"recurse", "tree"}
    assert all(k["execute_us"] > 0 for k in rec["kernels"].values())
    assert rec["plan_cache_hit"] == 0
    assert rec["edges_traversed"] > 0 and rec["bytes_gathered"] > 0
    a.query_batch(BATCH)
    assert costprofile.recent(1)[0]["plan_cache_hit"] == 1
    assert METRICS.get("cost_records_total", outcome="ok") >= 2
    assert costprofile.tablet_costs()["friend"] > 0
    plans, _left = plan_batch_groups_cached(a.mvcc.read_view(
        a.oracle.read_only_ts()), BATCH)
    for plan, _idxs in plans:
        assert _plan_shape(plan) in rec["shape"]


def test_recorder_work_off_and_on():
    """The port's counterpart of the reference's 5 % overhead guard,
    counted instead of timed: with profiling off no recorder opens and
    no record is kept; with it on, one record per request."""
    a = _alpha()
    q = '{ q(func: eq(name, "p9")) { name friend { name } } }'
    seen = []
    costprofile.add_sink(seen.append)
    base = costprofile.COSTS.records_total    # the set-up's mutation
    costprofile.set_enabled(False)
    for _ in range(5):
        a.query(q)
    assert costprofile.active() is None
    assert seen == [] and costprofile.COSTS.records_total == base
    costprofile.set_enabled(True)
    for _ in range(5):
        a.query(q)
    assert len(seen) == 5 and costprofile.COSTS.records_total == base + 5
    assert {r["shape"] for r in seen} == {"fused+q:eq~d1"}


def test_failed_request_is_classified():
    a = _alpha()
    with pytest.raises(Exception):
        a.query("{ q(func: eq(name, ) { name } }")
    assert costprofile.recent(1)[0]["outcome"] == "error"
    assert METRICS.get("cost_records_total", outcome="error") >= 1
