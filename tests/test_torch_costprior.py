"""The port's cost priors against the reference's, and the batch planner
and failure policy that use them.

`tests/test_costprior.py`'s prior-lifecycle cases run with the port's
objects bound in (the harness of `test_torch_lifecycle.py`:
`CostPriorModel`, `BLEND`, `PRIORS`, `Aggregator`, the port's `Alpha` on
the CPU), then with the reference's; their transcripts must be equal and
each run's own assertions hold. A fixed digest set refits to the same
model on both packages, number for number. Tolerance: exact.

The port's own checks: the batch answers are the same JSON with priors
on and off (the priors change the launch order, never an answer); the
cost gate and the ordering; and the failure policy — only an allocation
failure the evict-and-retry did not absorb is served per query; any
other error of a kernel group raises out of `Alpha.query_batch`. The
admission cases (SJF hand-off, displacement, idle decay) and the
`/debug/scheduler` case run in `test_torch_admission.py`; the A/B
acceptance needs `bench.sched_stage` and stays open (ROADMAP Queue 1);
the wall-clock overhead guard has a counted counterpart here.
"""

import json

import numpy as np
import pytest

import dgraph_tpu.utils.costprior as ref_costprior
import test_costprior
from dgraph_tpu_torch.engine import batch
from dgraph_tpu_torch.ops import bfs
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.utils import costprior, memgov
from dgraph_tpu_torch.utils.costprofile import Aggregator
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_lifecycle import PORT, REF, run_reference_case
from test_torch_memgov import reset_cost_state


@pytest.fixture(autouse=True)
def _clean():
    reset_cost_state()
    yield
    reset_cost_state()


CASES = ["test_refit_is_deterministic_for_a_fixed_digest_set",
         "test_unseen_shape_falls_back_to_lane_ema",
         "test_persistence_round_trip_through_checkpoint_and_open"]


@pytest.mark.parametrize("name", CASES)
def test_costprior_case_on_port(name, tmp_path, monkeypatch):
    port = run_reference_case(test_costprior, name, PORT,
                              tmp_path / "port", monkeypatch)
    reset_cost_state()
    ref = run_reference_case(test_costprior, name, REF, tmp_path / "ref",
                             monkeypatch)
    assert port == ref


def test_refit_equals_the_reference_number_for_number():
    """The same records refit to the same model state and the same
    feature fit on both packages."""
    from dgraph_tpu.utils.costprofile import Aggregator as RefAggregator
    rng = np.random.default_rng(5)
    recs = []
    for shape, base, lanes, depth in (("q:eq~d1", 500, 0, 0),
                                      ("recurse:friend~d3", 80_000, 32, 3),
                                      ("tree:*~d2", 20_000, 64, 2),
                                      ("shortest:knows~d8", 40_000, 32, 8)):
        for _ in range(24):
            recs.append({"shape": shape,
                         "total_us": int(base + rng.integers(0, base)),
                         "lanes": lanes, "depth": depth, "queries": 4})
    port_agg, ref_agg = Aggregator(), RefAggregator()
    for r in recs:
        port_agg.record(dict(r))
        ref_agg.record(dict(r))
    assert port_agg.to_state() == ref_agg.to_state()
    pm, rm = costprior.CostPriorModel(), ref_costprior.CostPriorModel()
    assert pm.refit(port_agg) == rm.refit(ref_agg)
    assert pm.to_state() == rm.to_state()
    for shape in ("q:eq~d1", "tree:*~d2", "recurse:friend~d3"):
        assert pm.predict_shape(shape) == rm.predict_shape(shape)
    feats = {"lanes": 64, "depth": 4, "queries": 8}
    assert pm.predict_features(feats) == rm.predict_features(feats)
    for text, us in (("a", 10.0), ("b", 2_000.0), ("a", 30.0)):
        pm.learn("read", text, "q:eq~d1", us, predicted_us=20.0,
                 source="prior")
        rm.learn("read", text, "q:eq~d1", us, predicted_us=20.0,
                 source="prior")
    assert pm.to_state() == rm.to_state()
    assert pm.predict("read", text="a") == rm.predict("read", text="a")
    ps, rs = pm.status(), rm.status()
    for k in ("shapes", "hits", "fallbacks", "refits", "error", "fit",
              "top", "lane_ema_us"):
        assert ps[k] == rs[k], k


def test_prior_work_per_request_is_counted():
    """The port's counterpart of the reference's 5 % overhead guard,
    counted instead of timed: with priors on each query makes one
    prediction and one learn; with the switch off it makes none."""
    a = _alpha()
    q = '{ q(func: uid(1)) { friend { uid } } }'
    calls = {"predict": 0, "learn": 0}
    model = costprior.PRIORS
    orig_predict, orig_learn = model.predict, model.learn

    def predict(*a_, **k):
        calls["predict"] += 1
        return orig_predict(*a_, **k)

    def learn(*a_, **k):
        calls["learn"] += 1
        return orig_learn(*a_, **k)

    model.predict, model.learn = predict, learn
    try:
        costprior.set_enabled(False)
        for _ in range(4):
            a.query(q)
        assert calls == {"predict": 0, "learn": 0}
        costprior.set_enabled(True)
        for _ in range(4):
            a.query(q)
        assert calls == {"predict": 4, "learn": 4}
    finally:
        del model.predict, model.learn


# -- the batch planner ------------------------------------------------------------

def _alpha():
    a = Alpha(device="cpu", device_threshold=0)
    a.alter("friend: [uid] @reverse .\nname: string @index(exact) .")
    rng = np.random.default_rng(4)
    lines = []
    for i in range(1, 61):
        lines.append(f'<{i}> <name> "p{i}" .')
        for j in rng.integers(1, 61, 3):
            if i != int(j):
                lines.append(f"<{i}> <friend> <{int(j)}> .")
    a.mutate(set_nquads="\n".join(lines))
    return a


# three families: 4 recurse, 12 tree, 8 shortest queries
BATCH = (["{ q(func: uid(%d)) @recurse(depth: 3) { friend uid } }" % i
          for i in range(1, 5)]
         + ['{ q(func: uid(%d)) { name friend { name friend { name } } } }'
            % i for i in range(1, 13)]
         + ['{ path as shortest(from: %d, to: %d) { friend } }'
            % (i, 61 - i) for i in range(1, 9)])


def test_batch_json_equal_with_priors_on_and_off():
    """Priors change the launch order, never an answer: the batch's JSON
    is byte-equal with the priors on and off, before and after the
    priors have learned the shapes, and the order really differs."""
    a = _alpha()
    view = a.mvcc.read_view(a.oracle.read_only_ts())
    plans, _left = batch.plan_batch_groups_cached(view, BATCH)
    assert len(plans) == 3
    on = batch.order_plans_by_cost(plans)
    assert [p for p, _ in on] != [p for p, _ in plans]
    gauges = METRICS.snapshot()["gauges"]
    assert gauges['plan_pack_imbalance{stage="count"}'] == 12 / 8
    costprior.set_enabled(False)
    want = json.dumps(a.query_batch(BATCH), sort_keys=True)
    costprior.set_enabled(True)
    assert json.dumps(a.query_batch(BATCH), sort_keys=True) == want
    # teach the priors that the shortest group is the longest
    shapes = {type(p): batch._plan_shape(p) for p, _ in plans}
    for _ in range(costprior.PRIORS.sample_floor):
        costprior.PRIORS.learn("read", None, shapes[batch._ShortestPlan],
                               9e6)
    first = batch.order_plans_by_cost(plans)[0][0]
    assert isinstance(first, batch._ShortestPlan)
    assert json.dumps(a.query_batch(BATCH), sort_keys=True) == want
    costprior.set_enabled(False)
    assert batch.order_plans_by_cost(plans) == plans


def test_a_fit_at_zero_is_no_prediction():
    """A feature fit that clamps at 0 µs for a group (a line over unlike
    shapes gone negative) is no prediction: the query count orders the
    groups, and never an all-zero tie in plan order."""
    a = _alpha()
    view = a.mvcc.read_view(a.oracle.read_only_ts())
    plans, _left = batch.plan_batch_groups_cached(view, BATCH)
    costprior.PRIORS._fit = {"intercept": -5.0, "coef": {"queries": 0.1}}
    assert costprior.PRIORS.predict_features({"queries": 12}) == 0.0
    costs = [batch.plan_cost_us(p) for p, _ in plans]
    assert costs == [1000.0 * batch._plan_queries(p) for p, _ in plans]
    on = batch.order_plans_by_cost(plans)
    assert [batch._plan_queries(p) for p, _ in on] == [12, 8, 4]
    costprior.PRIORS._fit = {"intercept": 5.0, "coef": {"queries": 0.0}}
    assert [batch.plan_cost_us(p) for p, _ in plans] == [5.0] * 3


def test_groups_learn_their_launch_shape_priors():
    """Each launched group teaches its launch shape's prior with its own
    measured run, with the priors on: after `sample_floor` batches every
    group is predicted by its prior, and the launch order is that of the
    priors. With the switch off nothing is learned."""
    a = _alpha()
    view = a.mvcc.read_view(a.oracle.read_only_ts())
    plans, _left = batch.plan_batch_groups_cached(view, BATCH)
    shapes = [batch._plan_shape(p) for p, _ in plans]
    costprior.set_enabled(False)
    a.query_batch(BATCH)
    assert all(costprior.PRIORS._shapes.get(s) is None for s in shapes)
    costprior.set_enabled(True)
    for _ in range(costprior.PRIORS.sample_floor):
        a.query_batch(BATCH)
    priors = [costprior.PRIORS.predict_shape(s) for s in shapes]
    assert all(us is not None and us > 0 for us in priors)
    assert [batch.plan_cost_us(p) for p, _ in plans] == priors
    order = [batch._plan_shape(p) for p, _ in
             batch.order_plans_by_cost(plans)]
    assert order == [s for _us, s in sorted(zip(priors, shapes),
                                            key=lambda t: -t[0])]


def test_kernel_worth_launches_a_small_expensive_group():
    """A group below MIN_BATCH joins the leftovers unless its shape's
    trusted prior predicts at least KERNEL_WORTH_US; the answers are
    the same either way."""
    a = _alpha()
    small = ["{ q(func: uid(%d)) @recurse(depth: 3) { friend uid } }" % i
             for i in range(1, 3)]
    launches = METRICS.get("kernel_group_launches_total", family="recurse")
    want = a.query_batch(small)
    assert METRICS.get("kernel_group_launches_total",
                       family="recurse") == launches
    for _ in range(costprior.PRIORS.sample_floor):
        costprior.PRIORS.learn("read", None, "recurse:friend~d3",
                               2 * batch.KERNEL_WORTH_US)
    assert batch._kernel_worth("recurse:friend~d3", 2)
    assert not batch._kernel_worth("recurse:friend~d4", 2)
    # a new schema fingerprint: the memoized plan predates the prior
    a.alter("nick: string .")
    assert a.query_batch(small) == want
    assert METRICS.get("kernel_group_launches_total",
                       family="recurse") == launches + 1
    costprior.set_enabled(False)
    assert not batch._kernel_worth("recurse:friend~d3", 2)


# -- the failure policy ----------------------------------------------------------

def _failing_recurse(monkeypatch, err):
    """Every recurse runner built from here on fails with `err`."""

    def make(*a, **k):
        def run(*a2, **k2):
            raise err
        return run

    monkeypatch.setattr(bfs, "make_ell_recurse", make)


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: out of memory"),
    AssertionError("kernel disagrees with its plain version")])
def test_non_allocation_failure_raises_out_of_query_batch(monkeypatch, err):
    """A kernel group's launch that fails for any reason but a classified
    allocation failure raises out of `Alpha.query_batch`: it is neither
    retried nor served per query, and no OOM is counted."""
    a = _alpha()
    _failing_recurse(monkeypatch, err)
    with pytest.raises(type(err)):
        a.query_batch(BATCH)
    assert memgov.GOVERNOR.oom_stats() == {"events": 0, "retries": 0,
                                           "degraded": 0}
    assert METRICS.get("query_errors_total", lane="read") >= 1


def test_degraded_group_is_served_per_query(monkeypatch):
    """Two allocation failures at the recurse launch: the second raises
    out of `query_batch`, counted as one event and logged; no query of
    the group is served per query or from the host, nothing degrades,
    and the next batch launches the group again with equal answers."""
    a = _alpha()
    want = a.query_batch(BATCH)
    launches = METRICS.get("kernel_group_launches_total", family="recurse")
    memgov.set_alloc_fault(lambda site: site == "bfs.ell_recurse")
    with pytest.raises(memgov.AllocFault):
        a.query_batch(BATCH)
    memgov.set_alloc_fault(None)
    st = memgov.GOVERNOR.oom_stats()
    assert st == {"events": 1, "retries": 1, "degraded": 0}
    assert METRICS.get("oom_events_total", site="bfs.ell_recurse") >= 1
    assert a.query_batch(BATCH) == want
    assert memgov.GOVERNOR.oom_stats() == st
    assert METRICS.get("kernel_group_launches_total",
                       family="recurse") == launches + 2
