"""The port stands alone: no jax, no grpc, nothing of dgraph_tpu, CUDA
by default.

The import pin runs in a subprocess because tests/conftest.py imports
jax (and the reference's tests grpc) into the pytest process. The HTTP
front end needs only the standard library; the gRPC worker comes with
the cluster (ROADMAP Queue 1 item 9e).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dgraph_tpu_torch")


def _port_files():
    for d, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _modules():
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        yield rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'dgraph_tpu' or "
        "m.startswith('dgraph_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'grpc' not in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_scan_covers_whole_block_programs_and_native():
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"engine/fused.py", "engine/emit.py", "ops/recurse.py",
            "native/__init__.py"} <= scanned


@pytest.mark.parametrize("path", sorted(_port_files())
                         + [os.path.join(ROOT, "chip_smoke.py")])
def test_no_file_imports_jax_or_reference(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "dgraph_tpu", "grpc"), \
                (path, n)


def test_scan_covers_the_lifecycle_modules():
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"utils/metrics.py", "utils/logging.py", "utils/tracing.py",
            "utils/deadline.py", "server/export.py", "server/backup.py",
            "store/maintenance.py", "dql/upsert.py", "loader/bulk.py",
            "loader/live.py"} <= scanned


def test_scan_covers_the_front_end_modules():
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"server/admission.py", "server/acl.py",
            "server/debug_routes.py", "server/fleet.py",
            "server/http.py"} <= scanned


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, an entry point called without device= raises; it
    never quietly runs on the CPU."""
    from dgraph_tpu_torch.engine import Engine
    from dgraph_tpu_torch.engine.batch import query_batch
    from dgraph_tpu_torch.ops import bfs
    from dgraph_tpu_torch.ops.uidalgebra import pad_to
    from dgraph_tpu_torch.store.store import StoreBuilder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    indptr = np.array([0, 1, 2, 2], np.int32)
    indices = np.array([1, 2], np.int32)
    g = bfs.build_ell(indptr, indices)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.device_ell(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.put_mask(bfs.pack_seed_masks(g, [[0]] * 32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.make_ell_count(g.outdeg, g.n)
    b = StoreBuilder()
    b.add_edge(1, "f", 2)
    store = b.finalize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        query_batch(store, ['{ q(func: uid(1)) @recurse(depth: 1) { f } }'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pad_to(np.arange(3), 4)
    assert Engine(store, device="cpu").query_bytes(
        '{ q(func: uid(1)) { f { uid } } }') == \
        b'{"q":[{"f":[{"uid":"0x2"}]}]}'
    # and with device="cpu" the same calls run
    assert bfs.device_ell(g, "cpu").device.type == "cpu"
