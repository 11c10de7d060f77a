"""The port's resilience layer against the reference's.

`tests/test_resilience.py` (the per-peer circuit breaker's state
machine, budget-aware retries that never retry a dead budget or an
application error, the retry-storm bound against a dead peer, the crash
and failover acceptance) runs twice through the cluster harness of
`test_torch_cluster.py`: the port's objects bound in, then the
reference's. The transcripts must be equal but for ports, ids, clocks
and breaker retry times (`test_torch_cluster.normalise`). The CLI's
heartbeat loop (`test_heartbeat_failures_metered_and_escalated`) runs
in `test_torch_cli.py`. `test_resilience_wrapper_overhead_under_5_percent` builds its
wrapped client's `PeerTable` with the lock sanitizer's switch cleared,
which the port's `utils/locks` reads as the reference's does.
"""

import pytest

import test_resilience
from test_torch_cluster import compare_cluster_case
from test_torch_lifecycle import reference_cases
from test_torch_lifecycle import settled_threads  # noqa: F401 (autouse)

CASES = reference_cases(test_resilience)
# reads the same answers until the breakers close, as often as the
# clock takes, and crashes the replica whose port sorts first
POLLS = {"test_crash_failover_acceptance"}


@pytest.mark.parametrize("name", CASES)
def test_resilience_case_on_port(name, tmp_path, monkeypatch):
    compare_cluster_case(test_resilience, name, tmp_path, monkeypatch,
                         polls=name in POLLS, port_ordered=name in POLLS)
