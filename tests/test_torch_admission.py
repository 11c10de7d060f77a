"""The port's admission control against the reference's.

`tests/test_admission.py`'s cases (FIFO order, queue-full and deadline
sheds, independent lanes, the overload acceptance with `/debug/admission`,
the HTTP 504 and 429 surfaces, maintenance yielding under load) and
`tests/test_costprior.py`'s admission cases (cheapest-predicted-first
hand-off, displacement, idle EMA decay, `/debug/scheduler`) run with the
port's objects bound in (the harness of `test_torch_lifecycle.py` with
HTTP answers recorded, `test_torch_http.py`), then with the
reference's; the transcripts must be equal and each run's own
assertions hold. Where threads decide the order of a transcript, the
sorted transcripts are compared. Tolerance: exact, but for the fields
`test_torch_http.py` names.

`test_admission.py`'s two lifecycle cases run in
`test_torch_lifecycle.py`; its two gRPC cases wait for the worker
transport (ROADMAP Queue 1 item 9e). Its wall-clock overhead guard has a
counted counterpart here: an uncontended request takes exactly one token
and waits in no queue, and a nested call takes none.

The port's own checks: a shed, a client's cancel and an ACL refusal stay
out of `query_errors_total`; a prediction of 0 µs or less reads as no
prediction (the lane EMA stands in), so admission never sees a request
as free.
"""

import threading

import numpy as np
import pytest

import test_admission
import test_costprior
from dgraph_tpu_torch.server.acl import AclError, AclManager
from dgraph_tpu_torch.server.admission import ServerOverloaded
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.utils import costprior, tracing
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.metrics import METRICS
from test_torch_http import compare_http_case
from test_torch_memgov import reset_cost_state

ADMISSION_CASES = ["test_fifo_admission_order",
                   "test_queue_full_sheds_with_retryable_hint",
                   "test_deadline_expired_while_queued_is_shed",
                   "test_mutate_lane_is_independent_of_read_lane",
                   "test_overload_acceptance_counts_and_debug_agree",
                   "test_http_timeout_param_returns_504",
                   "test_http_overload_returns_429_with_retry_after",
                   "test_maintenance_pace_yields_under_load"]
PRIOR_CASES = ["test_release_hands_token_to_cheapest_predicted_waiter",
               "test_cheap_arrival_displaces_most_expensive_queued",
               "test_idle_lane_ema_decays_to_seed",
               "test_debug_scheduler_surfaces_priors_and_error"]
CASES = ([(test_admission, n) for n in ADMISSION_CASES]
         + [(test_costprior, n) for n in PRIOR_CASES])
# concurrent requests finish (and so record) in thread order
UNORDERED = {"test_overload_acceptance_counts_and_debug_agree",
             "test_http_overload_returns_429_with_retry_after"}


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_reference_admission_case_on_port(module, name, tmp_path,
                                          monkeypatch):
    reset_cost_state()
    try:
        compare_http_case(module, name, tmp_path, monkeypatch,
                          unordered=name in UNORDERED,
                          between=reset_cost_state)
    finally:
        reset_cost_state()


def test_case_list_covers_the_module():
    """Every test_admission.py case runs on the port somewhere: here,
    in test_torch_lifecycle.py (the two lifecycle cases), or as the
    counted counterpart below; the gRPC two wait for item 9e."""
    from test_torch_lifecycle import ADMISSION_CASES as LIFECYCLE
    grpc = {"test_grpc_budget_forwarding_deadline",
            "test_peer_spans_reachable_over_worker_transport"}
    counted = {"test_uncontended_admission_overhead_under_5_percent"}
    every = {n for n in dir(test_admission) if n.startswith("test_")}
    assert every == set(ADMISSION_CASES) | set(LIFECYCLE) | grpc | counted


# -- the port's own checks --------------------------------------------------------

def _alpha(n=64):
    b = StoreBuilder(parse_schema("name: string @index(exact) .\n"
                                  "friend: [uid] @reverse ."))
    rng = np.random.default_rng(3)
    for i in range(1, n + 1):
        b.add_value(i, "name", f"p{i}")
        for j in rng.integers(1, n + 1, 3):
            b.add_edge(i, "friend", int(j))
    return Alpha(base=b.finalize(), device="cpu", device_threshold=10**9)


def test_uncontended_request_takes_one_token_and_waits_nowhere():
    """The counted counterpart of test_admission.py::
    test_uncontended_admission_overhead_under_5_percent: per request one
    acquire and one release, no `admission.wait` span, no queue; a txn
    read nested in a request rides its token."""
    a = _alpha()
    adm = a.attach_admission(max_inflight=64, queue_depth=64,
                             default_deadline_ms=30_000)
    lane = adm.lanes["read"]
    calls = {"acquire": 0, "release": 0}
    acquire, release = lane.acquire, lane.release

    def counted_acquire(*x, **k):
        calls["acquire"] += 1
        return acquire(*x, **k)

    def counted_release(*x, **k):
        calls["release"] += 1
        return release(*x, **k)

    lane.acquire, lane.release = counted_acquire, counted_release
    tracing.clear()
    qs = ['{ q(func: eq(name, "p%d")) { name friend { name } } }' % i
          for i in range(1, 9)]
    for q in qs:
        a.query(q)
    a.query_batch(qs)
    with a._request("read", None) as ctx:
        txn = a.new_txn()
        txn.query(qs[0])
        txn.discard()
        assert dl.current() is ctx
    assert calls == {"acquire": 10, "release": 10}
    assert lane.admitted_total == 10 and lane.shed_total == 0
    assert not [s for s in tracing.recent(4096)
                if s.name == "admission.wait"]
    assert adm.status()["lanes"]["read"]["inflight"] == 0


def test_shed_cancel_and_refusal_are_not_failed_serves():
    a = _alpha()
    a.attach_admission(max_inflight=1, queue_depth=0)
    q = '{ q(func: eq(name, "p1")) { name } }'
    e0 = METRICS.get("query_errors_total", lane="read")
    hold, release = threading.Event(), threading.Event()

    def holder():
        with a._request("read", None):
            hold.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    assert hold.wait(10)
    try:
        with pytest.raises(ServerOverloaded):
            a.query(q)
    finally:
        release.set()
        t.join(10)

    class Cancelled(dl.RequestContext):    # the client hung up at once
        def __init__(self, *x, **k):
            super().__init__(*x, **k)
            self.cancel()

    with pytest.MonkeyPatch.context() as m:
        m.setattr(dl, "RequestContext", Cancelled)
        with pytest.raises(dl.Cancelled):
            a.query(q)
    a.acl = AclManager(a, "s")
    a.acl.ensure_groot()
    with pytest.raises(AclError):
        a.query(q, acl_user='no"body')
    assert METRICS.get("query_errors_total", lane="read") == e0
    with pytest.raises(ValueError):
        a.query("{ q(func: eq(name, ")
    assert METRICS.get("query_errors_total", lane="read") == e0 + 1


def test_prediction_at_or_below_zero_reads_as_no_prediction(monkeypatch):
    """A prior or fit that says 0 µs (or less) is no prediction: the
    lane's observed-cost EMA rides the admission token instead, else
    the lane seed."""
    reset_cost_state()
    a = _alpha()
    adm = a.attach_admission(max_inflight=4, queue_depth=4)
    seen = []
    admit = adm.admit

    def spy(lane, ctx=None, cost_us=None):
        seen.append(cost_us)
        return admit(lane, ctx, cost_us=cost_us)

    monkeypatch.setattr(adm, "admit", spy)
    monkeypatch.setattr(costprior, "predict",
                        lambda lane, text=None: (0.0, "prior"))
    q = '{ q(func: eq(name, "p2")) { name } }'
    a.query(q)                       # nothing learned yet: the seed
    assert seen[-1] == costprior.LANE_SEED_US
    ema = costprior.lane_ema_us("read")
    assert ema is not None and ema > 0
    a.query(q)                       # the lane's EMA from then on
    assert seen[-1] == ema
    monkeypatch.setattr(costprior, "predict",
                        lambda lane, text=None: (-5.0, "prior"))
    ema = costprior.lane_ema_us("read")
    a.query(q)
    assert seen[-1] == ema
    assert all(c is not None and c > 0 for c in seen)
    reset_cost_state()
