"""The port's commit quorum, read gate and catch-up against the
reference's.

`tests/test_quorum.py` (majority commits, minority refusal, lost
decisions resolved at read time, undecided stages, asymmetric
partitions, elections, WAL recovery of a restarted replica) and the
cases of `tests/test_partition_fuzz.py` that are not marked slow run
twice through the cluster harness of `test_torch_cluster.py`: the port's
objects bound in, its Alphas on the CPU, then the reference's. The
transcripts must be equal but for ports, ids and clocks
(`test_torch_cluster.normalise`); the fuzz schedules whose outcomes
turn on the wall clock keep their own assertions (`FUZZ_CLOCKED`). Left out, each named in ROADMAP Queue 1
item 9f with what it waits for: the fuzz cases that read the lock
sanitizer (`test_partition_fuzz_smoke`, `test_crash_restart_fuzz_schedule`,
`test_disk_fault_fuzz_smoke`) or arm the flight recorder's watchdog
(those two and `test_alloc_fault_fuzz_smoke`).
"""

import pytest

import test_partition_fuzz
import test_quorum
from test_torch_cluster import compare_cluster_case
from test_torch_lifecycle import reference_cases

QUORUM_CASES = reference_cases(test_quorum)


@pytest.mark.parametrize("name", QUORUM_CASES)
def test_quorum_case_on_port(name, tmp_path, monkeypatch):
    compare_cluster_case(test_quorum, name, tmp_path, monkeypatch)


# lock sanitizer or armed watchdog (9f); `-m slow` explorations
FUZZ_SKIP = {"test_partition_fuzz_smoke", "test_crash_restart_fuzz_schedule",
             "test_disk_fault_fuzz_smoke", "test_alloc_fault_fuzz_smoke",
             "test_partition_fuzz_full", "test_crash_restart_fuzz_full"}
FUZZ_CASES = reference_cases(test_partition_fuzz, skip=FUZZ_SKIP)
# a seeded schedule of drops, delays and restarts: whether a transfer on
# a reachable node commits or is refused turns on the breakers' cool-
# downs and the delays on the wall clock, so these keep their own
# assertions (the bank invariant, minority refusal, convergence)
FUZZ_CLOCKED = {"test_deadline_fault_fuzz_schedule",
                "test_clock_free_delay_fuzz_smoke",
                "test_wal_truncation_fuzz_schedule",
                "test_wal_truncation_race_heals_via_fetchlog",
                "test_read_cancelled_mid_fetchlog_heal_retries_cleanly"}


@pytest.mark.parametrize("name", FUZZ_CASES)
def test_partition_fuzz_case_on_port(name, tmp_path, monkeypatch):
    compare_cluster_case(test_partition_fuzz, name, tmp_path, monkeypatch,
                         nondeterministic=name in FUZZ_CLOCKED)
