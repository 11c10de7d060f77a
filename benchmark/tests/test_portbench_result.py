"""The result line, the run's exits, and the readers' silence."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny_run

ROOT = harness.ROOT


def test_result_line_keys_and_checks_last():
    line = harness.result_line(True, 10, 0, {"setup_s": {"value": 1.5,
                                                          "unit": "s"}},
                               {"platform": "gpu", "kind": "k", "count": 1,
                                "memory_peak_bytes": 5},
                               None, {"lanes_off": {"value": 0, "limit": 0}})
    obj = json.loads(line)
    assert list(obj) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]


@pytest.mark.parametrize("workload", ["graph500-s20.recurse4-l4096",
                                      "snb-sf1-rag.knn-c8"])
def test_a_tiny_run_reports_the_cells_end_to_end_metrics(workload):
    res = tiny_run(workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in harness.reported(
        harness.manifest(candidates=True), workload, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["checked"] > 0


@pytest.mark.parametrize("workload", ["graph500-s20.recurse4-l4096",
                                      "snb-sf1-rag.knn-c8"])
def test_a_traced_tiny_run_reports_only_what_its_readers_find(workload):
    res = tiny_run(workload, trace=True)
    allowed = {m["name"] for m in harness.reported(
        harness.manifest(candidates=True), workload, "per_layer")}
    assert set(res["metrics"]) <= allowed
    # the CPU has no device trace: no roofline and no idle share
    assert not any("roofline" in k or "idle" in k for k in res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_candidate_cell_is_not_run_by_the_command():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "snb-sf1-rag.knn-c8", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "unknown workload" in r.stderr


def test_no_card_exits_without_a_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "graph500-s20.recurse4-l4096", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    if "CUDA device" not in r.stderr:
        pytest.skip("a CUDA card is present")
    assert r.returncode != 0 and r.stdout == ""


def test_the_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "graph500-s20.recurse4-l4096", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.parametrize("name", ["seed_upload_ms", "hop_roofline",
                                  "device_idle.traverse", "knn_roofline",
                                  "parse_us", "execute_ms", "render_us",
                                  "device_idle.serve"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert harness.read_metric(name, {}) is None
