"""The port's command line against the reference's.

The reference's cases that start its CLI (`test_torch_lifecycle.
CLI_CASES`) run through the lifecycle harness on both packages: the
port's run starts `python -m dgraph_tpu_torch` where the case starts
`python -m dgraph_tpu` (`--device cpu` after `alpha` and `live`), and
its in-process `cli.main` calls reach the port's `cli`. The transcripts
(every Alpha call, each CLI run's verb, flags, exit code and printed
JSON) must be equal. Three are held otherwise:

* `test_cluster.py::test_two_process_cluster_via_cli` runs on the port
  alone. The reference's run fails on its own code: gRPC reports a call
  without a deadline as ~9.2e18 s remaining, `server/task.py:
  _grpc_deadline_ms` makes that the request's budget, and the routed
  read forwards it as the `TabletSnapshot` leg's timeout, which
  overflows and fails at once with DEADLINE_EXCEEDED (ROADMAP Queue 3).
  `test_no_deadline_call_reads_a_foreign_tablet` pins that cause on
  both packages in one process.
* `test_vault.py::test_cli_key_flag` expects `VaultError` from a
  keyless load, and both packages raise `StorageCorruption` (the
  reference's fault, as for `test_encrypted_checkpoint_roundtrip` in
  `test_torch_checkpoint.py`): both packages run its steps here and
  refuse the keyless load the same way.
* `test_flightrec.py::test_http_acceptance_stalled_query_dumps_and_
  diagnose_pulls` races its watchdog and compares no transcript: it runs
  on the port here, and on the reference in its own file.

The port's own checks: equal typed configs from the same argv, every
verb and flag of the reference, the refusals (no card, the mesh flags),
`--version`, and an `alpha --device cpu` process that serves HTTP and
writes its checkpoint on SIGINT. Every test kills and waits for each
process it starts.
"""

import argparse
import dataclasses
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import dgraph_tpu.cli as ref_cli
# the modules the reference's engine imports at its first shortest-path
# request, loaded here at collection (every worker collects every file):
# a request that is still importing them when the flight recorder's
# watchdog convicts it has no span done and no `shortest` on its stack,
# which test_flightrec.py's acceptance case asserts (ROADMAP Queue 3)
import dgraph_tpu.engine.emit  # noqa: F401
import dgraph_tpu.engine.shortest  # noqa: F401
import dgraph_tpu.engine.varorder  # noqa: F401
import dgraph_tpu.server.task as ref_task
import dgraph_tpu.store.checkpoint as ref_checkpoint
import dgraph_tpu.store.vault as ref_vault
import dgraph_tpu.utils.config as ref_config
import dgraph_tpu.utils.costprofile as ref_costprofile
import dgraph_tpu.utils.flightrec as ref_flightrec
import test_backup
import test_cluster
import test_fleet
import test_flightrec
import test_loaders
import test_resilience
from dgraph_tpu_torch import __version__, cli
from dgraph_tpu_torch.server import task
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store import checkpoint, vault
from dgraph_tpu_torch.utils import config, costprofile, flightrec, tracing
from test_torch_cluster import compare_cluster_case
from test_torch_flightrec import reset_flight_state
from test_torch_lifecycle import (CLI_CASES, PORT, REF, Transcript, bound,
                                  compare_case, port_argv,
                                  run_reference_case)
from test_torch_lifecycle import settled_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _listed(module, name):
    assert name in CLI_CASES[module.__name__]
    return module, name


def _port_main_calls(monkeypatch) -> list:
    """The verbs of the port's `cli.main` calls from here on: a case's
    in-process CLI call on the port's run reaches the port's."""
    calls, real = [], cli.main

    def main(argv=None):
        calls.append(argv[0])
        return real(argv)

    monkeypatch.setattr(cli, "main", main)
    return calls


@pytest.fixture(autouse=True)
def _no_key():
    for v in (vault, ref_vault):
        v.set_key(None)
    yield
    for v in (vault, ref_vault):
        v.set_key(None)


# -- the reference's CLI cases ------------------------------------------------

FILE_CASES = [_listed(test_backup, "test_cli_backup_restore_roundtrip"),
              _listed(test_backup, "test_verify_cli_and_admin_endpoint"),
              _listed(test_loaders, "test_cli_bulk_debug_export")]


@pytest.mark.parametrize("module,name", FILE_CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in FILE_CASES])
def test_offline_verbs_case_on_port(module, name, tmp_path, monkeypatch):
    """bulk, debug, export, backup, backup verify and restore as
    processes; the printed JSON of each is in the transcript."""
    log = compare_case(module, name, tmp_path, monkeypatch)
    assert [e for e in log if e[0] == "cli"]


def test_heartbeat_loop_case_on_port(tmp_path, monkeypatch, caplog):
    """The loop meters every failure under its kind and escalates the
    third in a row to an error naming the dead Zero link."""
    module, name = _listed(test_resilience,
                           "test_heartbeat_failures_metered_and_escalated")
    logs = [run_reference_case(module, name, pkg, tmp_path / pkg,
                               monkeypatch, fixtures={"caplog": caplog})
            for pkg in (PORT, REF)]
    assert logs[0] == logs[1]


@pytest.fixture()
def _fleet_clean():
    """test_fleet.py's own reset, applied to both packages."""
    for mod in (flightrec, ref_flightrec):
        mod.disarm()
    for mod in (costprofile, ref_costprofile):
        mod.reset()
        mod.set_enabled(True)
    for mod in (tracing, test_fleet.tracing):
        mod.set_enabled(True)
    yield
    for mod in (flightrec, ref_flightrec):
        mod.disarm()


FLEET_CASES = ["test_diagnose_fleet_cli_writes_per_node_files",
               "test_fleet_cli_summary"]


@pytest.mark.parametrize("name", FLEET_CASES)
def test_fleet_cli_case_on_port(name, tmp_path, monkeypatch, capsys,
                                _fleet_clean):
    """`diagnose --fleet` and `fleet` against a two-group cluster."""
    _listed(test_fleet, name)
    calls = _port_main_calls(monkeypatch)
    compare_cluster_case(test_fleet, name, tmp_path, monkeypatch,
                         fixtures={"capsys": capsys})
    assert calls == [name.split("_")[1]]


def _warm_shortest_over_http(tmp):
    """One shortest query over HTTP on a small chain: the case's first
    query must not pay the port's first imports, or the watchdog
    convicts it inside them (no span done, no `shortest` on its stack)."""
    with pytest.MonkeyPatch.context() as m, \
            bound(test_flightrec, PORT, m, Transcript(tmp)):
        a, q = test_flightrec._chain_alpha(64)
        http = importlib.import_module(PORT + ".server.http")
        srv = http.make_http_server(a)
        http.serve_background(srv)
        try:
            _http(f"http://127.0.0.1:{srv.server_address[1]}", "/query", q)
        finally:
            srv.shutdown()
            srv.server_close()


def test_diagnose_case_on_port(tmp_path, monkeypatch, capsys):
    """A stalled query's watchdog bundle, then `diagnose` pulls one, on
    the port. The case races its watchdog's 20 ms poll (the convicted
    request's stack must be inside the shortest grind), so it has no
    transcript to compare; the reference's run is its own file's
    (test_flightrec.py), which lost that race once in this suite's
    six-worker runs with the lock sanitizer tracing every acquire."""
    module, name = _listed(
        test_flightrec,
        "test_http_acceptance_stalled_query_dumps_and_diagnose_pulls")
    calls = _port_main_calls(monkeypatch)
    _warm_shortest_over_http(tmp_path)
    reset_flight_state()
    try:
        run_reference_case(module, name, PORT, tmp_path, monkeypatch,
                           fixtures={"capsys": capsys})
    finally:
        reset_flight_state()
    assert calls == ["diagnose"]


def test_two_process_cluster_via_cli_on_port(tmp_path, monkeypatch):
    """A Zero and two Alphas as processes: alter, mutate, and the
    cross-node read. On the port alone: the reference's run of this
    case fails on its own deadline fault (module docstring)."""
    module, name = _listed(test_cluster, "test_two_process_cluster_via_cli")
    run_reference_case(module, name, PORT, tmp_path, monkeypatch)


def test_cli_key_flag_held_on_both(tmp_path, capsys):
    """test_vault.py::test_cli_key_flag's steps on both packages: bulk
    with a key file, a keyless load refused the same way by both, and
    debug with the key, whose documents are equal."""
    kf = tmp_path / "key"
    kf.write_bytes(os.urandom(32))
    rdf = tmp_path / "d.rdf"
    rdf.write_text('_:a <name> "cli-enc" .\n_:a <friend> _:b .\n'
                   '_:b <name> "other" .\n')
    refused, docs = {}, {}
    for pkg, main, vlt, ckpt in ((PORT, cli.main, vault, checkpoint),
                                 (REF, ref_cli.main, ref_vault,
                                  ref_checkpoint)):
        out = str(tmp_path / pkg)
        assert main(["bulk", "--files", str(rdf), "--out", out,
                     "--encryption_key_file", str(kf)]) == 0
        vlt.set_key(None)
        with pytest.raises(Exception) as ei:
            ckpt.load(out)
        refused[pkg] = type(ei.value).__name__
        capsys.readouterr()
        assert main(["debug", "--p", out,
                     "--encryption_key_file", str(kf)]) == 0
        docs[pkg] = json.loads(capsys.readouterr().out)
        vlt.set_key(None)
    assert refused[PORT] == refused[REF] == "StorageCorruption"
    assert docs[PORT] == docs[REF]
    assert docs[PORT]["predicates"]["friend"]["edges"] == 1


# -- the cause of the two-process case's DEADLINE_EXCEEDED --------------------

class _NoDeadline:
    """A servicer context of a call made without a timeout, as gRPC
    reports it."""

    def time_remaining(self):
        return 9.223372036854776e18


def test_grpc_call_without_deadline_carries_no_budget():
    assert task._grpc_deadline_ms(_NoDeadline()) is None
    assert ref_task._grpc_deadline_ms(_NoDeadline()) > 1e21

    class Five:
        def time_remaining(self):
            return 5.0

    assert task._grpc_deadline_ms(Five()) == \
        ref_task._grpc_deadline_ms(Five()) == 5000.0
    assert task._grpc_deadline_ms(None) is None


def _read_foreign_without_deadline(pkg):
    """One process: a Zero, two single-node groups, `name` on the
    first; a gRPC `Query` without a timeout to the second reads `name`.
    The smallest input that shows the fault."""
    import grpc

    if pkg == PORT:
        from dgraph_tpu_torch.cluster import start_cluster_alpha
        from dgraph_tpu_torch.cluster.zero import ZeroClient, make_zero_server
        kw = {"device": "cpu"}
    else:
        from dgraph_tpu.cluster import start_cluster_alpha
        from dgraph_tpu.cluster.zero import ZeroClient, make_zero_server
        kw = {}
    Client = (task if pkg == PORT else ref_task).Client
    zs, zport, _ = make_zero_server()
    zs.start()
    zt = f"127.0.0.1:{zport}"
    servers = [zs]
    try:
        a1, s1, _addr1 = start_cluster_alpha(zt, device_threshold=10**9, **kw)
        servers.append(s1)
        a2, s2, addr2 = start_cluster_alpha(zt, device_threshold=10**9, **kw)
        servers.append(s2)
        ZeroClient(zt).should_serve("name", a1.groups.gid)
        a1.alter("name: string @index(exact) .")
        a1.mutate(set_nquads='_:a <name> "alice" .', commit_now=True)
        a2.groups.refresh()
        try:
            return Client(addr2).query(
                '{ q(func: eq(name, "alice")) { name } }')
        except grpc.RpcError as e:
            return (e.code().name, e.details())
    finally:
        for s in servers:
            s.stop(None)


def test_no_deadline_call_reads_a_foreign_tablet():
    """The port answers; the reference fails at once inside the
    TabletSnapshot leg, its budget the overflowing 'no deadline'."""
    assert _read_foreign_without_deadline(PORT) == \
        {"q": [{"name": "alice"}]}
    assert _read_foreign_without_deadline(REF) == \
        ("DEADLINE_EXCEEDED", "budget expired inside TabletSnapshot RPC")


# -- the typed config and the flag surface ------------------------------------

class _Stop(Exception):
    pass


def _config_of(mod, cfg_mod, argv, monkeypatch):
    """The AlphaConfig `mod.main(argv)` builds, caught before the verb
    touches anything."""
    def capture(cls, path=None, overrides=None):
        raise _Stop(cfg_mod.load_config(cls, path, overrides))

    with monkeypatch.context() as m:
        m.setattr(mod, "load_config", capture)
        with pytest.raises(_Stop) as got:
            mod.main(argv)
    return dataclasses.asdict(got.value.args[0])


def _alpha_argv(tmp_path):
    kf = tmp_path / "key"
    kf.write_bytes(b"k" * 32)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"rollup_every": 7, "http_port": 1}))
    return ["alpha", "--p", str(tmp_path / "p"), "--config", str(cfg_file),
            "--http_port", "18081", "--grpc_port", "19081",
            "--store", "device_threshold=77; rollup_every=9; "
                       "queue_depth=3; forecast_shedding=off",
            "--mesh-devices", "2", "--acl_secret_file", str(kf),
            "--jax-coordinator", "h:1", "--zero", "z:1", "--heartbeat", "2",
            "--group", "3", "--memory_budget_mb", "5",
            "--device_budget_mb", "6", "--host_cache_budget_mb", "7",
            "--rollup_after", "8", "--checkpoint_every_s", "1.5",
            "--maintenance_pacing_ms", "2.5", "--slow_query_ms", "11",
            "--trace_dir", str(tmp_path / "tr"),
            "--trace_export", str(tmp_path / "otlp.json"),
            "--telemetry_push_url", "http://127.0.0.1:9",
            "--telemetry_push_interval_s", "0.5",
            "--diag_dir", str(tmp_path / "diag"), "--stall_factor", "3",
            "--stall_floor_ms", "40", "--max_inflight", "4",
            "--queue_depth", "12", "--default_deadline_ms", "250",
            "--no-cost_priors", "--ts_interval_s", "0.5",
            "--ts_ring_points", "99", "--slo_spec", "error_rate=0.5",
            "--rpc_retries", "4", "--breaker_threshold", "6",
            "--breaker_cooldown_ms", "700", "--log_level", "debug",
            "--encryption_key_file", str(kf), "--encryption_strict"]


def test_same_argv_gives_equal_configs(tmp_path, monkeypatch):
    """Every alpha flag, a config file, --store superflags (a dedicated
    flag wins) and the --no- booleans: both packages build the same
    AlphaConfig; `device` is the port's own field."""
    argv = _alpha_argv(tmp_path)
    port = _config_of(cli, config, argv, monkeypatch)
    ref = _config_of(ref_cli, ref_config, argv, monkeypatch)
    assert port.pop("device") == "cuda"
    assert port == ref
    assert (ref["device_threshold"], ref["rollup_every"],
            ref["queue_depth"], ref["cost_priors"],
            ref["forecast_shedding"], ref["mesh_devices"],
            ref["encryption_strict"]) == (77, 9, 12, False, False, 2, True)
    assert _config_of(cli, config, ["alpha", "--device", "cpu"],
                      monkeypatch)["device"] == "cpu"
    assert _config_of(cli, config, ["alpha", "--store", "device=cpu"],
                      monkeypatch)["device"] == "cpu"
    both = (_config_of(cli, config, ["alpha", "--forecast_shedding"],
                       monkeypatch),
            _config_of(ref_cli, ref_config, ["alpha", "--forecast_shedding"],
                       monkeypatch))
    assert both[0].pop("device") == "cuda" and both[0] == both[1]


@pytest.mark.parametrize("word", ["maybe", "ture", "2"])
def test_bad_booleans_raise_in_both(word, monkeypatch):
    for mod, cfg_mod in ((cli, config), (ref_cli, ref_config)):
        with pytest.raises(ValueError, match="invalid boolean"):
            _config_of(mod, cfg_mod, ["alpha", "--store",
                                      f"cost_priors={word}"], monkeypatch)
        with pytest.raises(ValueError, match="invalid boolean"):
            cfg_mod.load_config(cfg_mod.AlphaConfig,
                                overrides={"encryption_strict": word})


def test_load_config_and_superflag_match_the_reference(tmp_path):
    assert config.parse_superflag(" a=1; b = x=y ;;") == \
        ref_config.parse_superflag(" a=1; b = x=y ;;") == \
        {"a": "1", "b": "x=y"}
    with pytest.raises(ValueError):
        config.parse_superflag("novalue")
    f = tmp_path / "c.json"
    f.write_text(json.dumps({"grpc_port": 5, "unknown": 1, "first_ts": 9}))
    for cls in ("AlphaConfig", "ZeroConfig"):
        port = dataclasses.asdict(config.load_config(
            getattr(config, cls), str(f), {"log_level": "warn"}))
        ref = dataclasses.asdict(ref_config.load_config(
            getattr(ref_config, cls), str(f), {"log_level": "warn"}))
        port.pop("device", None)
        assert port == ref


def _parser(main):
    """The top-level parser `main` builds."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["p"] = self
        raise _Stop()

    with pytest.MonkeyPatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Stop):
            main([])
    return seen["p"]


def _surface(main) -> dict:
    sub = next(a for a in _parser(main)._actions
               if isinstance(a, argparse._SubParsersAction))
    return {verb: {(tuple(a.option_strings) or (a.dest,)): (
                a.default, tuple(a.choices or ()), a.required)
                   for a in p._actions if a.dest != "help"}
            for verb, p in sub.choices.items()}


def test_every_verb_and_flag_of_the_reference():
    """The same subcommands, each flag with the reference's name,
    default, choices and requiredness; `--device` is the port's own
    flag of `alpha` and `live`."""
    port, ref = _surface(cli.main), _surface(ref_cli.main)
    assert set(port) == set(ref) == {
        "alpha", "zero", "bulk", "live", "backup", "restore", "export",
        "debug", "diagnose", "fleet"}
    assert port["alpha"].pop(("--device",))[0] is None
    assert port["live"].pop(("--device",))[0] == "cuda"
    assert port == ref


def test_version():
    r = subprocess.run([sys.executable, "-m", PORT, "--version"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"dgraph_tpu_torch {__version__}"


# -- the refusals -------------------------------------------------------------

@pytest.mark.parametrize("verb", ["alpha", "live"])
def test_no_card_exits_before_touching_the_directory(verb, tmp_path,
                                                     monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "p"
    rdf = tmp_path / "d.rdf"
    rdf.write_text('_:a <name> "x" .\n')
    argv = ["alpha", "--p", str(p)] if verb == "alpha" else \
        ["live", "--files", str(rdf), "--p", str(p)]
    with pytest.raises(SystemExit) as ei:
        cli.main(argv)
    assert ei.value.code != 0 and "--device cpu" in str(ei.value.code)
    assert not p.exists()


def test_no_card_process_exits_nonzero(tmp_path):
    """The whole process, as an operator starts it, on this CPU-only
    machine."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the alpha would serve")
    p = tmp_path / "p"
    r = subprocess.run([sys.executable, "-m", PORT, "alpha", "--p", str(p)],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert not p.exists()


@pytest.mark.parametrize("argv,flag", [
    (["--mesh-devices", "2"], "--mesh-devices 2"),
    (["--mesh-devices", "-1"], "--mesh-devices -1"),
    (["--store", "mesh_devices=4"], "--mesh-devices 4"),
    (["--device", "cpu", "--mesh-devices", "-1", "--jax-coordinator",
      "127.0.0.1:1"], "--jax-coordinator"),
    (["--device", "cpu", "--jax-coordinator", "127.0.0.1:1"],
     "--jax-coordinator 127.0.0.1:1"),
    (["--device", "cpu", "--mesh-devices", "-1", "--jax-coordinator",
      "127.0.0.1:1", "--max_inflight", "2"], "--max_inflight 2")])
def test_mesh_flags_refused_naming_item_10(argv, flag, tmp_path,
                                           monkeypatch):
    """A mesh wider than this machine's cards (none here) exits before
    the directory exists, naming the device count; so does a coordinator
    without a rank and a world size (the env pair is unset), naming what
    is missing, a coordinator without `--mesh-devices`, and a coordinator
    beside admission control, which sheds per process. A working mesh
    across processes is `test_torch_multihost.py`'s CLI case."""
    import torch
    if torch.cuda.is_available() and "--jax-coordinator" not in " ".join(
            argv):
        pytest.skip("a card is present: the mesh may fit")
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    p = tmp_path / "p"
    with pytest.raises(SystemExit) as ei:
        cli.main(["alpha", "--p", str(p), *argv])
    msg = str(ei.value.code)
    assert flag in msg
    if "--mesh-devices" in flag:
        want = "all" if flag.endswith("-1") else flag.split()[-1]
        assert f"asks for {want} devices and this machine has 0" in msg
    elif "--max_inflight" in flag:
        assert "admission control sheds per process" in msg
    elif "--mesh-devices" in argv:
        assert "without the number of processes" in msg and \
            "JAX_PROCESS_ID" in msg
    else:
        assert "give --mesh-devices too" in msg
    assert not p.exists()


@pytest.mark.parametrize("n,shards", [(2, 2), (-1, 1)])
def test_mesh_devices_serve_on_cpu_shards(n, shards, tmp_path, monkeypatch):
    """`--device cpu --mesh-devices N` opens the Alpha over N CPU
    shards (-1: one), the mesh built before the directory is touched."""
    from dgraph_tpu_torch.server import api

    def capture(*a, mesh=None, **kw):
        raise _Stop(mesh)

    monkeypatch.setattr(api.Alpha, "open", staticmethod(capture))
    with pytest.raises(_Stop) as got:
        cli.main(["alpha", "--device", "cpu", "--p", str(tmp_path / "p"),
                  "--mesh-devices", str(n)])
    mesh = got.value.args[0]
    assert mesh.size == shards and mesh.device_type == "cpu"


def test_port_argv_translation():
    py = sys.executable
    assert port_argv([py, "-m", REF, "alpha", "--p", "x"]) == \
        [py, "-m", PORT, "alpha", "--device", "cpu", "--p", "x"]
    assert port_argv([py, "-m", REF, "live", "--files", "f"]) == \
        [py, "-m", PORT, "live", "--device", "cpu", "--files", "f"]
    assert port_argv([py, "-m", REF, "backup", "verify", "--dest", "d"]) \
        == [py, "-m", PORT, "backup", "verify", "--dest", "d"]
    other = [py, "-c", "print(1)"]
    assert port_argv(other) is other


# -- an alpha process on the CPU ----------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CHAIN = 100_000
WIDE_Q = "{ q(func: has(link)) { uid link { uid link { uid } } } }"


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _http(base, path, body=None, ctype="application/dql", timeout=30):
    req = urllib.request.Request(
        base + path, data=None if body is None else body.encode(),
        headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_health(proc, base, err, limit_s=90.0):
    deadline = time.monotonic() + limit_s
    while True:
        try:
            urllib.request.urlopen(base + "/health", timeout=5).read()
            return
        except OSError:
            assert proc.poll() is None, "".join(err)
            assert time.monotonic() < deadline, "".join(err)
            time.sleep(0.2)


def _reader(proc, err):
    t = threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True)
    t.start()
    return t


def _stop(proc, reader):
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    reader.join(10)
    for f in (proc.stdout, proc.stderr):
        if f is not None:
            f.close()


def test_alpha_started_before_its_zero_joins_once_zero_listens(tmp_path):
    """An alpha whose Zero is not yet listening retries the join each
    second (as upstream Dgraph's alpha does) and serves once a Zero
    comes up on that port."""
    zport, hport = _free_port(), _free_port()
    alpha = subprocess.Popen(
        [sys.executable, "-m", PORT, "alpha", "--device", "cpu",
         "--p", str(tmp_path / "p"), "--http_port", str(hport),
         "--grpc_port", str(_free_port()), "--zero", f"127.0.0.1:{zport}",
         "--ts_interval_s", "0"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    err = []
    reader = _reader(alpha, err)
    zero = None
    try:
        deadline = time.monotonic() + 90
        while "retrying the join" not in "".join(err):
            assert alpha.poll() is None, "".join(err)
            assert time.monotonic() < deadline, "".join(err)
            time.sleep(0.1)
        zero = subprocess.Popen(
            [sys.executable, "-m", PORT, "zero", "--port", str(zport)],
            cwd=ROOT, stderr=subprocess.DEVNULL)
        _wait_health(alpha, f"http://127.0.0.1:{hport}", err)
        assert "joined cluster: node=1" in "".join(err)
    finally:
        _stop(alpha, reader)
        if zero is not None:
            zero.kill()
            zero.wait()


def test_alpha_process_serves_and_checkpoints_on_sigint(tmp_path):
    """`alpha --device cpu`: /health, /alter, /mutate?commitNow and
    /query over HTTP, `--no-cost_priors` off in /debug/scheduler; SIGINT
    while a query is in flight lets it end, drains maintenance and
    writes the final checkpoint, which the port's Alpha reads back."""
    p = tmp_path / "p"
    hport = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", PORT, "alpha", "--device", "cpu",
         "--p", str(p), "--http_port", str(hport),
         "--grpc_port", str(_free_port()), "--ts_interval_s", "0",
         "--no-cost_priors"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err = []
    reader = _reader(proc, err)
    base = f"http://127.0.0.1:{hport}"
    try:
        _wait_health(proc, base, err)
        _http(base, "/alter", "name: string @index(exact) .\n"
                              "friend: [uid] .\nlink: [uid] .")
        doc = _http(base, "/mutate?commitNow=true",
                    '_:a <name> "alice" .\n_:b <name> "bob" .\n'
                    '_:a <friend> _:b .', ctype="application/rdf")
        assert doc["data"]["txn"]["commit_ts"]
        q = '{ q(func: eq(name, "alice")) { name friend { name } } }'
        want = {"q": [{"name": "alice", "friend": [{"name": "bob"}]}]}
        assert _http(base, "/query", q)["data"] == want
        assert _get(base, "/debug/scheduler")["enabled"] is False
        # SIGINT while a wide read is in flight: it ends, then the
        # checkpoint, then exit 0
        _http(base, "/mutate?commitNow=true", "\n".join(
            f"_:n{i} <link> _:n{i + 1} ." for i in range(CHAIN)),
            ctype="application/rdf")
        path = {}
        walk = threading.Thread(target=lambda: path.update(_http(
            base, "/query", WIDE_Q, timeout=120)))
        walk.start()
        deadline = time.monotonic() + 60
        while _get(base, "/debug/flightrecorder")["inflight"] < 1:
            assert walk.is_alive() and time.monotonic() < deadline
            time.sleep(0.01)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, "".join(err)
        walk.join(60)
        assert len(path["data"]["q"]) == CHAIN
    finally:
        _stop(proc, reader)
    assert "draining maintenance" in "".join(err)
    assert "on cpu" in "".join(err)
    a = Alpha.open(str(p), device="cpu")
    try:
        assert a.query(q) == want
    finally:
        a.wal.close()
