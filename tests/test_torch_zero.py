"""The port's Zero against the reference's.

`tests/test_zero_ha.py` (liveness, the standby's journal replication,
failover with monotonic timestamps, lease gating, compaction, `/state`
from Zero's membership, an Alpha that survives a Zero failover) and
`tests/test_zero_hardening.py` (the journal across restarts, expired
transactions, tablet moves under load, rebalancing, moves that never
target an unhealthy peer, identities reclaimed after a Zero restart) run
twice through the cluster harness of `test_torch_cluster.py`: the port's
objects bound in (its Zero holds no tensors; its Alphas run on the CPU),
then the reference's. The transcripts must be equal but for ports, ids
and clocks (`test_torch_cluster.normalise`).
"""

import pytest

import test_zero_ha
import test_zero_hardening
from test_torch_cluster import compare_cluster_case
from test_torch_lifecycle import reference_cases
from test_torch_lifecycle import settled_threads  # noqa: F401 (autouse)

CASES = [(test_zero_ha, n) for n in reference_cases(test_zero_ha)] + \
    [(test_zero_hardening, n) for n in reference_cases(test_zero_hardening)]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_zero_case_on_port(module, name, tmp_path, monkeypatch):
    compare_cluster_case(module, name, tmp_path, monkeypatch)
