"""Nothing the benchmark runs imports JAX or the JAX package; names are
compared by whole top-level name."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.parametrize("mods,bad", [
    (["dgraph_tpu_torch", "dgraph_tpu_torch.ops.bfs", "numpy"], []),
    (["dgraph_tpu.ops"], ["dgraph_tpu"]),
    (["jaxlib.xla_client", "jaxtyping", "flax.linen"], ["flax", "jaxlib"]),
    (["jax"], ["jax"]),
])
def test_forbidden_modules_compare_top_level_names_whole(mods, bad):
    assert harness.forbidden_modules(mods) == bad


def sources():
    for d, _sub, files in os.walk(harness.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imports_of(path) & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources():
        if os.sep + "reference" + os.sep in path:
            assert imports_of(path) <= {"__future__", "dataclasses", "json",
                                        "warnings", "numpy", "torch",
                                        "benchmark"}, path


def test_a_run_leaves_no_forbidden_module_loaded():
    code = ("import sys; from benchmark.tests.conftest import tiny_run; "
            "tiny_run('snb-sf1-rag.knn-c8'); "
            "tiny_run('graph500-s20.recurse4-l4096'); "
            "from benchmark import harness; "
            "print(harness.forbidden_modules(list(sys.modules)))")
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
