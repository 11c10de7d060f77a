"""The port's resilience layer against the reference's.

`tests/test_resilience.py` (the per-peer circuit breaker's state
machine, budget-aware retries that never retry a dead budget or an
application error, the retry-storm bound against a dead peer, the crash
and failover acceptance) runs twice through the cluster harness of
`test_torch_cluster.py`: the port's objects bound in, then the
reference's. The transcripts must be equal but for ports, ids, clocks
and breaker retry times (`test_torch_cluster.normalise`). Left out,
each named in ROADMAP Queue 1 item 9f: `test_heartbeat_failures_metered_
and_escalated` (the CLI's heartbeat loop) and `test_resilience_wrapper_
overhead_under_5_percent` (the lock sanitizer).
"""

import pytest

import test_resilience
from test_torch_cluster import compare_cluster_case
from test_torch_lifecycle import reference_cases

SKIP = {"test_heartbeat_failures_metered_and_escalated",
        "test_resilience_wrapper_overhead_under_5_percent"}
CASES = reference_cases(test_resilience, skip=SKIP)
# reads the same answers until the breakers close, as often as the
# clock takes, and crashes the replica whose port sorts first
POLLS = {"test_crash_failover_acceptance"}


@pytest.mark.parametrize("name", CASES)
def test_resilience_case_on_port(name, tmp_path, monkeypatch):
    compare_cluster_case(test_resilience, name, tmp_path, monkeypatch,
                         polls=name in POLLS, port_ordered=name in POLLS)
