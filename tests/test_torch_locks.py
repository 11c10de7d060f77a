"""The port's lock-order and race sanitizers against the reference's.

`tests/test_locks.py` and `tests/test_races.py` run through the
lifecycle harness (`test_torch_lifecycle.compare_case`): first with
every `dgraph_tpu.*` name bound to the port's (`utils/locks.py`, the
port's Alpha, admission, pusher, out-of-core store, Zero and WAL on the
CPU), then with the reference's own; the transcripts must be equal.
`tests/conftest.py` sets `DGRAPH_TPU_LOCK_SANITIZER=1` and
`DGRAPH_TPU_RACE_SANITIZER=1` before anything is imported, and the port
reads the same switches, so every port lock in this process is traced
and every port class with a lock discipline is armed: the cases that
read the live graph and race table (`test_tier1_runs_instrumented_and_
acyclic`, the `*_is_lock_disciplined` regressions) check the port's.

Two reference cases run as port counterparts below:
`test_suite_runs_race_instrumented_and_clean` names the reference's
file (`dgraph_tpu/utils/metrics.py:Registry`) among the tracked
classes, where the port's is `dgraph_tpu_torch/utils/metrics.py`; and
the two `test_query_path_overhead_under_5_percent` guards are wall-clock
ratios of an engine on the CPU (the reference's own flakes under the
suite's six workers), so the port's armed-versus-disarmed cost is
measured on the card instead (`chip_smoke.py` phase 16 (a) and (e)).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import test_locks
import test_races
from dgraph_tpu_torch.utils import locks
from test_torch_lifecycle import compare_case, reference_cases

OVERHEAD = {"test_query_path_overhead_under_5_percent"}
LOCK_CASES = reference_cases(test_locks, skip=OVERHEAD)
RACE_CASES = reference_cases(test_races, skip=OVERHEAD | {
    "test_suite_runs_race_instrumented_and_clean"})


@pytest.mark.parametrize("name", LOCK_CASES)
def test_lock_case_on_port(name, tmp_path, monkeypatch):
    compare_case(test_locks, name, tmp_path, monkeypatch)


@pytest.mark.parametrize("name", RACE_CASES)
def test_race_case_on_port(name, tmp_path, monkeypatch):
    compare_case(test_races, name, tmp_path, monkeypatch)


# -- port counterparts -----------------------------------------------------------

def test_suite_runs_race_instrumented_and_clean_on_port():
    """The reference case with the port's file names: the switches are
    on, the port's metrics registry is armed, and no race was seen in
    this process so far."""
    assert locks.race_enabled()
    from dgraph_tpu_torch.utils.metrics import METRICS
    assert getattr(type(METRICS), "_race_shim_", False)
    snap = locks.RACES.snapshot()
    assert snap["enabled"] and snap["tracked_classes"]
    assert "dgraph_tpu_torch/utils/metrics.py:Registry" \
        in snap["tracked_classes"]
    assert snap["reports"] == [], snap["reports"]


def test_no_plain_lock_outside_the_constructors():
    """Every lock of the port is made by `locks.make_lock` /
    `make_rlock` / `make_condition` under a name."""
    import pathlib
    import re
    root = pathlib.Path(locks.__file__).resolve().parents[1]
    plain = re.compile(r"threading\.(Lock|RLock|Condition)\(")
    found = [f"{p.relative_to(root)}:{i}"
             for p in sorted(root.rglob("*.py"))
             if p.name not in ("locks.py",)
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if plain.search(line)]
    assert found == []


_OWN_LOCKS = textwrap.dedent("""
    import json
    import numpy as np
    from dgraph_tpu_torch.utils import locks
    from dgraph_tpu_torch.utils import device, kbuild, tracing
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.engine import fused, treebatch
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.store.store import StoreBuilder
    from dgraph_tpu_torch.store.schema import parse_schema

    b = StoreBuilder(parse_schema("link: [uid] @reverse .\\n"
                                  "name: string @index(exact) ."))
    u = np.arange(1, 600, dtype=np.int64)
    b.add_edges("link", u, u + 1)
    for i in range(1, 601):
        b.add_value(i, "name", f"n{i}")
    a = Alpha(base=b.finalize(), device="cpu", device_threshold=0)
    a.query('{ q(func: eq(name, "n1")) { link { link { uid } } } }')
    a.query('{ q(func: uid(0x1)) @filter(eq(name, "n1")) '
            '{ link @filter(has(name)) { uid } } }')
    store = a.mvcc.base
    names = {
        "device": device.DEVICE_WIDE.name,
        "kbuild": kbuild._lock.name, "native": native._lock.name,
        "profile": tracing._PROFILE_LOCK.name,
        "fused": fused._lock.name, "treebatch": treebatch._cache_lock.name,
        "place": store._place_lock.name, "filter": store._filter_lock.name,
        "alpha": a._state_lock.name,
    }
    with device.DEVICE_WIDE:        # what a capture holds
        store.device_rel("link", True, "cpu")
    snap = locks.GRAPH.snapshot()
    print(json.dumps({"names": names, "snap": snap,
                      "races": locks.RACES.snapshot()["reports"]}))
""")


def test_port_locks_traced_by_name_in_a_fresh_process():
    """With the switches set at process start, the port's own locks
    (the card-wide lock, the placement and filter locks, the build
    locks, the program registry) are traced under their names, appear
    in the order graph by name once nested, and a CPU serve leaves no
    cycle and no race."""
    env = dict(os.environ, DGRAPH_TPU_LOCK_SANITIZER="1",
               DGRAPH_TPU_RACE_SANITIZER="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _OWN_LOCKS], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["names"] == {
        "device": "device.wide", "kbuild": "kbuild.build",
        "native": "native.build", "profile": "tracing.profile",
        "fused": "fused.registry", "treebatch": "treebatch.cache",
        "place": "store.place", "filter": "store.filter",
        "alpha": "alpha.state"}
    snap = doc["snap"]
    assert snap["enabled"] and snap["acquires_total"] > 0
    seen = {e["from"] for e in snap["edges"]} | \
        {e["to"] for e in snap["edges"]}
    assert "device.wide" in seen and "store.place" in seen
    assert snap["cycles"] == []
    assert doc["races"] == []
