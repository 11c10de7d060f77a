"""The port stands alone: no jax, nothing of dgraph_tpu, grpc only in
the cluster, CUDA by default.

The import pin runs in a subprocess because tests/conftest.py imports
jax (and the reference's tests grpc) into the pytest process. `grpc` is
imported by the cluster's transport alone: the protos, the gRPC worker
(`server/task.py`) and `cluster/{zero,groups,resilience,routed,fault}.py`,
and, inside the functions of their cluster branches only, by
`server/{http,fleet,api}.py` and `cli.py` (its Zero join). Importing the
single-node modules (every other one: the server, the engine, the
store, the utils, the CLI) loads no `grpc`; the HTTP front end needs
only the standard library.
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


# the files that may import grpc at module level, and those that may
# import it only inside a function (their cluster branches)
GRPC_FILES = {"protos/__init__.py", "protos/task_pb2.py", "server/task.py",
              "cluster/zero.py", "cluster/groups.py",
              "cluster/resilience.py", "cluster/routed.py",
              "cluster/fault.py"}
LAZY_GRPC_FILES = {"server/http.py", "server/fleet.py", "server/api.py",
                   "cli.py"}


def _single_node_modules():
    grpc_mods = {m.replace("/", ".")[:-3] for m in GRPC_FILES}
    return sorted(m for m in _modules()
                  if m[len("dgraph_tpu_torch."):] not in grpc_mods
                  and m[len("dgraph_tpu_torch."):].replace(
                      ".__init__", "") not in grpc_mods)


def _import_in_subprocess(modules, *asserts):
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(modules)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'dgraph_tpu' or "
        "m.startswith('dgraph_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules\n"
        + "".join(f"assert {a}\n" for a in asserts) +
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_import_loads_no_jax_and_no_reference():
    """Every module of the port, the cluster's included."""
    _import_in_subprocess(_modules())


def test_single_node_modules_load_no_grpc():
    """The server, engine, store and utils modules (and the cluster
    package's `start_cluster_alpha`, which imports its transport when
    called) load no grpc."""
    mods = _single_node_modules()
    assert {"dgraph_tpu_torch.server.api", "dgraph_tpu_torch.server.http",
            "dgraph_tpu_torch.server.fleet", "dgraph_tpu_torch.engine",
            "dgraph_tpu_torch.store.store",
            "dgraph_tpu_torch.utils.memgov", "dgraph_tpu_torch.cli",
            "dgraph_tpu_torch.__main__",
            "dgraph_tpu_torch.utils.config"} <= set(mods)
    _import_in_subprocess(mods, "'grpc' not in sys.modules")


def test_cli_loads_no_grpc_until_a_cluster_verb_runs():
    """The CLI, its entry module and its typed config alone: the alpha
    and zero verbs import the transport inside their functions, and
    torch waits for a verb that needs it (`diagnose`, `fleet` and
    `--version` start without it)."""
    _import_in_subprocess(["dgraph_tpu_torch.cli",
                           "dgraph_tpu_torch.__main__",
                           "dgraph_tpu_torch.utils.config"],
                          "'grpc' not in sys.modules",
                          "'torch' not in sys.modules")


def test_scan_covers_whole_block_programs_and_native():
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    assert {"engine/fused.py", "engine/emit.py", "ops/recurse.py",
            "native/__init__.py"} <= scanned


def _imports(tree):
    """(top-level name, inside a function) of every import in `tree`."""
    out = []

    def walk(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], in_fn)
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.append(((child.module or "").split(".")[0], in_fn))
            walk(child, fn)

    walk(tree, False)
    return out


@pytest.mark.parametrize("path", sorted(_port_files())
                         + [os.path.join(ROOT, "chip_smoke.py")])
def test_no_file_imports_jax_or_reference(path):
    """jax and dgraph_tpu nowhere, chip_smoke.py included; grpc only
    where the module doc allows it."""
    rel = os.path.relpath(path, PKG)
    tree = ast.parse(open(path).read(), path)
    for top, in_fn in _imports(tree):
        assert top not in ("jax", "jaxlib", "dgraph_tpu"), (path, top)
        if top == "grpc":
            assert rel in GRPC_FILES or (rel in LAZY_GRPC_FILES and in_fn), \
                (path, "imports grpc")


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


def test_scan_covers_the_observability_modules():
    """The flight recorder, the metrics history, the SLO engine, the
    telemetry pusher and the sanitizers are scanned and load on their
    own without jax or the reference package."""
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    mods = {"utils/locks.py", "analysis/guards.py", "utils/flightrec.py",
            "utils/timeseries.py", "utils/slo.py", "utils/push.py"}
    assert mods <= scanned
    _import_in_subprocess(
        ["dgraph_tpu_torch." + m[:-3].replace("/", ".") for m in mods])


def test_scan_covers_the_mesh_modules():
    """Mesh serving in one process: the mesh, its placements and
    programs are scanned and load on their own without jax or the
    reference package."""
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    mods = {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/pshard.py", "parallel/dhop.py", "parallel/dsort.py",
            "parallel/dbfs.py"}
    assert mods <= scanned
    _import_in_subprocess(
        ["dgraph_tpu_torch." + m[:-3].replace("/", ".").replace(
            ".__init__", "") for m in mods], "'grpc' not in sys.modules")


def test_scan_covers_the_cluster_modules():
    scanned = {os.path.relpath(p, PKG) for p in _port_files()}
    assert GRPC_FILES | {"cluster/tablet.py", "cluster/oracle.py",
                         "cluster/__init__.py"} <= scanned


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs.bitmap_recurse(np.zeros(1, np.int32), np.zeros(1, np.int32),
                           np.ones(1, np.int32), np.ones((1, 1), np.int8), 1)
    from dgraph_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(2)
    b = StoreBuilder()
    b.add_edge(1, "f", 2)
    store = b.finalize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        query_batch(store, ['{ q(func: uid(1)) @recurse(depth: 1) { f } }'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pad_to(np.arange(3), 4)
    from dgraph_tpu_torch.cluster import start_cluster_alpha
    # raises before it dials Zero (no Zero listens at this address)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        start_cluster_alpha("127.0.0.1:1")
    assert Engine(store, device="cpu").query_bytes(
        '{ q(func: uid(1)) { f { uid } } }') == \
        b'{"q":[{"f":[{"uid":"0x2"}]}]}'
    # and with device="cpu" the same calls run
    assert bfs.device_ell(g, "cpu").device.type == "cpu"
