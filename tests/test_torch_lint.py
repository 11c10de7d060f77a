"""The port's static analysis (`dgraph_tpu_torch.analysis`) against the
reference's analyzer, and the port under it.

* Every synthetic-fixture case of `tests/test_lint.py` (R1-R15 and the
  waiver grammar) runs with its `scan` run through BOTH analyzers: the
  reference's on the fixture as written, the port's on the fixture with
  `dgraph_tpu.`/`dgraph_tpu/` written as `dgraph_tpu_torch.`/
  `dgraph_tpu_torch/`, and a file with a port twin of another name
  mapped to it (`bench.py` → `chip_smoke.py`, the bench-role script;
  `utils/jaxcompat.py` → `parallel/mesh.py`, R7's home). The two must
  give the same (rule, line, waived) findings; the case's own
  assertions then run on the port's analyzer.
* The gate: the port scanned by the port's analyzer has no unwaived
  finding, every waiver has a reason, and where the reference waives a
  twin site the port's waiver gives the reference's reason.
* The facts inventory: both hand kernels with their `csrc/` sources,
  load and launch sites, the captured programs, and every inventory
  pinned both ways against the port's runtime registry.
* R6 and R13 on the port's capture idiom (`torch.cuda.graph`), R7 on
  `torch.distributed`, and the facts held against a CPU run of the port
  in a fresh process, the rehearsal of `chip_smoke.py` phase 18 (b).
"""

import ast
import functools
import inspect
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import test_feat
import test_lint
import test_metrics
import test_timeseries
from dgraph_tpu.analysis import FileContext as RefFileContext
from dgraph_tpu_torch.analysis import Analyzer, FileContext
from dgraph_tpu_torch.analysis import run as port_run
from dgraph_tpu_torch.analysis.facts import runtime_misses
from dgraph_tpu_torch.analysis.rules import default_rules
from test_torch_lifecycle import PORT, run_reference_case

ROOT = pathlib.Path(__file__).resolve().parents[1]

# files whose port twin has another name
TWINS = {"bench.py": "chip_smoke.py",
         "dgraph_tpu/utils/jaxcompat.py": "dgraph_tpu_torch/parallel/mesh.py"}


def to_port(text: str) -> str:
    return (text.replace("dgraph_tpu/", "dgraph_tpu_torch/")
            .replace("dgraph_tpu.", "dgraph_tpu_torch."))


def port_scan(rel: str, source: str, readme: str = "") -> Analyzer:
    """The port's full rule set over one in-memory file."""
    a = Analyzer(rules=default_rules(), repo_root=ROOT, readme_text=readme)
    a.add_source(rel, source)
    a.finish()
    return a


def triples(a) -> set:
    return {(f.rule, f.line, f.waived) for f in a.findings}


def _scans(name: str) -> bool:
    fn = getattr(test_lint, name)
    return "scan(" in inspect.getsource(fn)


FIXTURE_CASES = [n for n, fn in vars(test_lint).items()
                 if n.startswith("test_") and inspect.isfunction(fn)
                 and _scans(n)]


@functools.lru_cache(maxsize=1)
def _port():
    return port_run(ROOT)


@pytest.mark.parametrize("name", FIXTURE_CASES)
def test_reference_fixture_case_on_port(name, monkeypatch):
    ref_scan = test_lint.scan
    seen = []

    def both(rel, source, readme=""):
        ref = ref_scan(rel, source, readme)
        port = port_scan(TWINS.get(rel, to_port(rel)), to_port(source),
                         readme)
        assert triples(port) == triples(ref), (rel, source)
        seen.append(rel)
        return port

    monkeypatch.setattr(test_lint, "scan", both)
    getattr(test_lint, name)()
    assert seen


def test_fixture_cases_cover_every_rule():
    """The parametrised cases above reach each of the fifteen rules and
    the waiver grammar."""
    assert len(FIXTURE_CASES) >= 50
    names = {r.name for r in default_rules()}
    assert len(names) == 15
    for rule in names:
        assert any(rule in inspect.getsource(getattr(test_lint, n))
                   for n in FIXTURE_CASES), rule
    assert "test_reasonless_waiver_is_a_finding_and_does_not_waive" \
        in FIXTURE_CASES


# -- the gate ----------------------------------------------------------------------

def test_port_has_zero_unwaived_findings():
    a = _port()
    bad = a.unwaived()
    assert not bad, "graftlint findings:\n" + "\n".join(
        f.format() for f in bad)


def test_every_waiver_carries_a_reason():
    a = _port()
    assert not [f for f in a.findings if f.rule == "waiver-syntax"]
    waived = [f for f in a.findings if f.waived]
    assert waived and all(f.reason for f in waived)


# reference waivers whose site has no twin in the port
NO_TWIN = {("engine/feat.py", "O(log n) shift arithmetic"):
           "the port's engine/feat.py has no _bucket of its own; it uses "
           "engine/execute.py's, which carries the same waiver"}


def test_twin_sites_keep_the_references_waiver_reasons():
    """Every waiver of a reference file is in its port twin, with the
    same rules and the reference's reason."""
    checked = 0
    for f in sorted((ROOT / "dgraph_tpu").rglob("*.py")):
        rel = f.relative_to(ROOT / "dgraph_tpu").as_posix()
        if rel.startswith("analysis/"):
            continue
        ref = RefFileContext(rel, f.read_text()).waivers
        twin = ROOT / "dgraph_tpu_torch" / rel
        if not ref or not twin.exists():
            continue
        port = {(frozenset(r), why) for r, why, _ok
                in FileContext(rel, twin.read_text()).waivers.values()}
        for line, (rules, why, _ok) in ref.items():
            if (rel, why) in NO_TWIN:
                continue
            assert (frozenset(rules), why) in port, (rel, line, why)
            checked += 1
    assert checked >= 30


def test_metric_scan_not_blind():
    a = _port()
    names = {m["name"] for m in a.facts["metric_sites"]}
    assert len(names) > 30, "metric scan went blind — check the rule"
    # the port's own names are documented too
    assert {"taskhop_to_pull_total", "kernel_builds_total",
            "outofcore_faults_total", "outofcore_evictions_total",
            "cache_replacements_total"} <= names


def _line_of(rel: str, text: str) -> int:
    lines = (ROOT / rel).read_text().splitlines()
    (hit,) = [i for i, ln in enumerate(lines, 1) if text in ln]
    return hit


def test_facts_inventory_shapes():
    """Both hand kernels with their sources, load and launch sites; the
    captured programs of engine/fused.py and their capture site; the
    span, lock and guarded vocabularies."""
    a = _port()
    t = a.facts["totals"]
    assert t["hand_kernels"] == 2
    assert t["span_names"] >= 15 and t["lock_classes"] >= 15
    hand = {k["name"]: k for k in a.facts["kernels"] if k["route"] == "cuda"}
    hop, feat = "dgraph_tpu_torch/ops/bucket_hop.py", \
        "dgraph_tpu_torch/ops/feat.py"
    for name, rel in (("bucket_hop", hop), ("segment_combine", feat)):
        k = hand[name]
        assert k["source"] == f"dgraph_tpu_torch/csrc/{name}.cu"
        assert (ROOT / k["source"]).exists()
        assert k["load_sites"] == [{"file": rel, "line": _line_of(
            rel, f'kbuild.load("{name}")')}]
        assert k["launch_sites"] == [{"file": rel, "line": _line_of(
            rel, "fn, err_str = _kernel()")}]
    fused = "dgraph_tpu_torch/engine/fused.py"
    captured = {k["name"] for k in a.facts["kernels"]
                if k["route"] == "capture" and k["file"] == fused}
    assert captured == {"program", "_emit_hop", "_emit_recurse",
                        "_emit_count", "_emit_knn", "_emit_featprop"}
    capture = [s for s in a.facts["kernel_launch_sites"]
               if s["kind"] == "capture" and s["file"] != "chip_smoke.py"]
    assert capture == [{"kernel": "program", "kind": "capture",
                        "file": fused,
                        "line": _line_of(fused, "torch.cuda.graph(")}]
    ladder = {x["name"] for x in a.facts["lock_classes"]}
    assert {"metrics.registry", "mvcc.store", "wal.write", "device.wide",
            "kbuild.build", "admission.*"} <= ladder


def test_cost_record_schema_shares_the_facts_vocabulary():
    from dgraph_tpu_torch.utils import costprofile
    a = _port()
    facts_fields = {f["name"]: f["kind"]
                    for f in a.facts["cost_record_fields"]}
    assert facts_fields == {n: d["kind"]
                            for n, d in costprofile.FIELDS.items()}
    assert a.facts["totals"]["cost_record_fields"] \
        == len(costprofile.FIELDS)
    rec = costprofile.Recorder("read").finish("ok")
    assert set(rec) == set(costprofile.FIELDS)


def test_cost_prior_features_pinned_to_cost_fields():
    from dgraph_tpu_torch.utils import costprior, costprofile
    a = _port()
    assert [f["name"] for f in a.facts["cost_prior_features"]] \
        == list(costprior.FEATURES)
    for f in a.facts["cost_prior_features"]:
        assert costprofile.FIELDS[f["name"]]["kind"] == "feature"
    assert set(costprior.FEATURES) == set(costprofile.FEATURE_FIELDS)


def test_debug_endpoint_inventory_pinned_both_ways():
    from dgraph_tpu_torch.server import http
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.server.debug_routes import DEBUG_ENDPOINTS
    a = _port()
    assert {e["path"]: e["doc"] for e in a.facts["debug_endpoints"]} \
        == DEBUG_ENDPOINTS
    assert set(http._DEBUG_GET) == set(DEBUG_ENDPOINTS)
    assert set(http._DEBUG_POST) <= set(DEBUG_ENDPOINTS)
    srv = http.make_http_server(Alpha(device="cpu", device_threshold=10**9))
    try:
        for table in (http._DEBUG_GET, http._DEBUG_POST):
            for route, meth in table.items():
                assert callable(getattr(srv.RequestHandlerClass, meth,
                                        None)), (route, meth)
    finally:
        srv.server_close()


def test_fused_stage_inventory_pinned_both_ways():
    """The facts read STAGE_KINDS from engine/fused.py's source (the
    module imports torch); it equals the imported dict, the emitter
    registry, and what a plan emits."""
    from dgraph_tpu_torch.dql.parser import parse
    from dgraph_tpu_torch.engine import fused
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder
    a = _port()
    assert {e["kind"]: e["doc"] for e in a.facts["fused_stage_kinds"]} \
        == fused.STAGE_KINDS
    assert set(fused.STAGE_KINDS) == set(fused._STAGE_EMITTERS)
    b = StoreBuilder(parse_schema("knows: [uid] @reverse ."))
    b.add_edge(1, "knows", 2)
    plan = fused.plan_block(b.finalize(), parse(
        '{ q(func: uid(0x1)) @recurse(depth: 2) { uid knows } }')[0])
    assert plan is not None
    assert {s.kind for s in plan.stages} <= set(fused.STAGE_KINDS)


def test_governed_cache_inventory_pinned_both_ways():
    from dgraph_tpu_torch.utils import memgov
    a = _port()
    assert {e["name"]: e["doc"] for e in a.facts["governed_caches"]} \
        == memgov.GOVERNED_CACHES
    with pytest.raises(ValueError):
        memgov.GOVERNOR.register("not.a.cache", "host",
                                 lambda: 0, lambda: 0)
    literals = {n.value for ctx in a.contexts
                if ctx.rel != "dgraph_tpu_torch/utils/memgov.py"
                for n in ctx.nodes(ast.Constant)
                if isinstance(n.value, str)}
    assert not set(memgov.GOVERNED_CACHES) - literals


def test_slo_spec_inventory_pinned_both_ways():
    from dgraph_tpu_torch.utils import slo
    a = _port()
    assert {e["name"]: e["doc"] for e in a.facts["slo_specs"]} \
        == slo.SLO_SPECS
    assert set(slo._EVALUATORS) == set(slo.SLO_SPECS)
    with pytest.raises(ValueError):
        slo._evaluator("not_an_objective")
    with pytest.raises(ValueError):
        slo.parse_spec("typo_rate=0.5")
    assert set(slo.DEFAULT_TARGETS) == set(slo.SLO_SPECS)


# -- the lock discipline: one inventory for both halves ---------------------------

def test_guarded_fields_inventory_shape():
    a = _port()
    inv = {(g["file"], g["class"]): g for g in a.facts["guarded_fields"]}
    reg = inv[("dgraph_tpu_torch/utils/metrics.py", "Registry")]
    assert "_counters" in reg["fields"] and reg["lock"] == "metrics.registry"
    assert ("dgraph_tpu_torch/store/mvcc.py", "MVCCStore") in inv
    assert ("dgraph_tpu_torch/server/admission.py", "_Lane") in inv
    assert a.facts["totals"]["guarded_classes"] >= 15
    assert a.facts["totals"]["guarded_fields"] >= 60
    # the eviction callback memgov.govern_dict runs under the lock it was
    # handed: its writes count as locked (the lock hand-off)
    lazy = inv[("dgraph_tpu_torch/store/outofcore.py", "LazyPreds")]
    assert {"_sizes", "resident_bytes", "evictions"} <= set(lazy["fields"])


def test_guarded_sites_pin_inventory_both_ways():
    a = _port()
    inv_keys = {(g["file"], g["class"]) for g in a.facts["guarded_fields"]}
    site_keys = {(s["file"], s["class"]) for s in a.facts["guarded_sites"]}
    assert not inv_keys - site_keys
    assert not site_keys - inv_keys
    by_key: dict = {}
    for g in a.facts["guarded_fields"]:
        by_key.setdefault((g["file"], g["class"]), set()).add(g["lock"])
    for s in a.facts["guarded_sites"]:
        assert s["lock"] in by_key[(s["file"], s["class"])], s


def test_runtime_inventory_is_the_facts_inventory():
    """utils/locks.py arms what analysis/guards.runtime_inventory says,
    and that is the facts' guarded_fields, entry for entry."""
    from dgraph_tpu_torch.analysis.guards import runtime_inventory
    a = _port()
    facts: dict = {}
    for g in a.facts["guarded_fields"]:
        facts.setdefault((g["file"], g["class"]), {"locks": {}})["locks"][
            g["lock_attr"]] = {"lock": g["lock"],
                               "fields": tuple(g["fields"])}
    assert runtime_inventory() == facts


def test_runtime_registry_matches_static_inventory():
    from dgraph_tpu_torch.server.admission import AdmissionController
    from dgraph_tpu_torch.utils import locks
    from dgraph_tpu_torch.utils.push import TelemetryPusher
    AdmissionController(max_inflight=1, queue_depth=1)
    TelemetryPusher("http://127.0.0.1:1")
    a = _port()
    inv: dict = {}
    for g in a.facts["guarded_fields"]:
        inv.setdefault((g["file"], g["class"]), set()).update(g["fields"])
    reg = locks.RACES.registered
    for key in [("dgraph_tpu_torch/server/admission.py", "_Lane"),
                ("dgraph_tpu_torch/utils/push.py", "TelemetryPusher"),
                ("dgraph_tpu_torch/utils/metrics.py", "Registry")]:
        assert key in reg, f"{key} never registered at runtime"
        assert set(reg[key]["fields"]) == inv[key]


# -- the CLI -----------------------------------------------------------------------

def test_cli_json_runs_clean_without_torch():
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "dgraph_tpu_torch.analysis",
         "--format=json"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["findings"] == []
    assert sum(doc["counts"]["waived"].values()) >= 10
    assert doc["facts"]["totals"]["hand_kernels"] == 2
    loaded = {ln.split("|")[-1].strip().split(".")[0]
              for ln in out.stderr.splitlines() if "|" in ln}
    assert not loaded & {"torch", "jax", "dgraph_tpu"}, loaded


def test_cli_text_mode_and_exit_codes(tmp_path):
    bad = tmp_path / "dgraph_tpu_torch" / "engine" / "loop.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(x):\n    while x:\n        x -= 1\n")
    run = [sys.executable, "-m", "dgraph_tpu_torch.analysis"]
    out = subprocess.run(run + ["--facts", str(bad)], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 1
    assert "[hot-loop-checkpoint]" in out.stdout and "facts:" in out.stdout
    out = subprocess.run(run + ["--no-such-flag"], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 2


# -- the reference's other analyzer cases, run on the port -------------------------

OTHER_CASES = [(test_feat, "test_compare_gate_watches_feature_bytes_per_s"),
               (test_metrics, "test_every_emitted_metric_name_is_documented"),
               (test_timeseries, "test_bench_compare_gate")]


@pytest.mark.parametrize("module,name", OTHER_CASES,
                         ids=[n for _m, n in OTHER_CASES])
def test_reference_analyzer_case_on_port(module, name, tmp_path,
                                         monkeypatch, capsys):
    run_reference_case(module, name, PORT, tmp_path, monkeypatch,
                       fixtures={"capsys": capsys})


# -- the port's capture idiom ------------------------------------------------------

CAPTURE_BAD = """\
import torch
from dgraph_tpu_torch.utils import costprofile
from dgraph_tpu_torch.utils.metrics import METRICS

def stage(x):
    n = x.sum().item()
    METRICS.inc("edges_traversed_total")
    costprofile.add("edges_traversed", n)
    return x + 1

def capture(g, x):
    with torch.cuda.graph(g):
        return stage(x)
"""

CAPTURE_OK = """\
import torch
from dgraph_tpu_torch.utils import costprofile
from dgraph_tpu_torch.utils.metrics import METRICS

def stage(x):
    return x + 1

def launch(g, x):
    with torch.cuda.graph(g):
        out = stage(x)
    n = out.sum().item()
    METRICS.inc("edges_traversed_total")
    costprofile.add("edges_traversed", n)
    return out
"""


def _rules(a, waived=False) -> dict:
    out: dict = {}
    for f in a.findings:
        if f.waived == waived:
            out.setdefault(f.rule, []).append(f)
    return out


def test_r6_r13_fire_inside_a_cuda_graph_capture():
    a = port_scan("dgraph_tpu_torch/engine/fused.py", CAPTURE_BAD,
                  readme="`edges_traversed_total`")
    got = _rules(a)
    assert [f.line for f in got["jit-purity"]] == [6]
    assert ".item()" in got["jit-purity"][0].msg
    assert sorted(f.line for f in got["fused-host-callback"]) == [7, 8]
    assert any("METRICS.inc" in f.msg for f in got["fused-host-callback"])


def test_r6_r13_clean_outside_the_capture():
    a = port_scan("dgraph_tpu_torch/engine/fused.py", CAPTURE_OK,
                  readme="`edges_traversed_total`")
    assert "jit-purity" not in _rules(a)
    assert "fused-host-callback" not in _rules(a)
    # R13 holds in the fused-program layer only; R6 everywhere
    a = port_scan("dgraph_tpu_torch/server/fake.py", CAPTURE_BAD,
                  readme="`edges_traversed_total`")
    assert "fused-host-callback" not in _rules(a)
    assert "jit-purity" in _rules(a)


BUILT_PROGRAM = """\
import torch

def _emit(x):
    return x.tolist()

_EMITTERS = {"one": _emit}

def _build(kind):
    def program(x):
        return _EMITTERS[kind](x)
    return program

class _Program:
    def __init__(self, fn):
        self.fn = fn

    def capture(self, g, x):
        with torch.cuda.graph(g):
            self.out = self.fn(x)

def get(kind):
    return _Program(_build(kind))
"""


def test_capture_follows_the_program_a_class_was_built_with():
    """engine/fused.py's shape: the capture calls `self.fn`, which the
    class holds from `_build`; the rule follows it to `program` and,
    through the module's table of emitters, to `_emit`."""
    a = port_scan("dgraph_tpu_torch/ops/fake.py", BUILT_PROGRAM)
    got = _rules(a)
    assert [f.line for f in got["jit-purity"]] == [4]
    assert "_emit()" in got["jit-purity"][0].msg
    names = {k["name"] for k in a.facts["kernels"]
             if k["route"] == "capture"}
    assert names == {"program", "_emit"}


def test_capture_of_a_call_it_cannot_follow_is_a_finding():
    src = BUILT_PROGRAM.replace("return _Program(_build(kind))",
                                "return _Program(lookup(kind))")
    a = port_scan("dgraph_tpu_torch/ops/fake.py", src)
    (f,) = _rules(a)["jit-purity"]
    assert f.line == 19 and "self.fn()" in f.msg


def test_r7_flags_torch_distributed_outside_the_mesh_module():
    src = ("import torch.distributed as dist\n"
           "from torch import distributed\n"
           "import torch\n"
           "torch.distributed.all_reduce(t)\n")
    a = port_scan("dgraph_tpu_torch/engine/fake.py", src)
    assert [f.line for f in _rules(a)["shard-map-compat"]] == [1, 2, 4]
    a = port_scan("dgraph_tpu_torch/parallel/mesh.py", src)
    assert "shard-map-compat" not in _rules(a)


def test_r7_accepts_collectives_in_the_mesh_module_only():
    """The mesh module as shipped (its torch.distributed import carries
    the multi-process mesh), with one more torch.distributed collective
    added, passes R7 at its own path; the same file anywhere else is
    flagged at its import and at that collective, and only there."""
    src = open(os.path.join(ROOT, "dgraph_tpu_torch/parallel/mesh.py")
               ).read()
    imports = [i + 1 for i, text in enumerate(src.splitlines())
               if text.strip() == "import torch.distributed as dist"]
    assert imports
    extra = "\n\ndef _all_reduce(t):\n    torch.distributed.all_reduce(t)\n"
    line = (src + extra).count("\n")
    a = port_scan("dgraph_tpu_torch/parallel/mesh.py", src + extra)
    assert "shard-map-compat" not in _rules(a)
    a = port_scan("dgraph_tpu_torch/parallel/dhop.py", src + extra)
    assert [f.line for f in _rules(a)["shard-map-compat"]] == \
        imports + [line]
    a = port_scan("dgraph_tpu_torch/parallel/dhop.py", src)
    assert [f.line for f in _rules(a)["shard-map-compat"]] == imports


def test_r12_exempts_only_the_ports_locks_module():
    src = "import threading\nx = threading.Lock()\n"
    assert "untracked-lock" in _rules(
        port_scan("dgraph_tpu_torch/utils/fake.py", src))
    assert "untracked-lock" not in _rules(
        port_scan("dgraph_tpu_torch/utils/locks.py", src))


# -- the facts against a run of the port (chip_smoke.py phase 18 (b)) -------------

_CPU_RUN = textwrap.dedent("""
    import json, urllib.request
    import numpy as np
    from dgraph_tpu_torch.analysis import run
    from dgraph_tpu_torch.analysis.facts import runtime_misses
    from dgraph_tpu_torch.server import http
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.store.schema import parse_schema
    from dgraph_tpu_torch.store.store import StoreBuilder
    from dgraph_tpu_torch.utils import locks, memgov, tracing
    from dgraph_tpu_torch.utils.metrics import METRICS

    b = StoreBuilder(parse_schema("link: [uid] @reverse .\\n"
                                  "name: string @index(exact) ."))
    u = np.arange(1, 300, dtype=np.int64)
    b.add_edges("link", u, u + 1)
    for i in range(1, 301):
        b.add_value(i, "name", f"n{i}")
    a = Alpha(base=b.finalize(), device="cpu", device_threshold=0)
    a.attach_admission(4, 8)
    srv = http.make_http_server(a)
    http.serve_background(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, body, ct="application/dql"):
        req = urllib.request.Request(base + path, data=body.encode(),
                                     headers={"Content-Type": ct})
        with urllib.request.urlopen(req) as r:
            return r.read()

    try:
        post("/query", '{ q(func: eq(name, "n1")) { link { link { uid } } } }')
        post("/query", '{ q(func: uid(0x1)) @recurse(depth: 3) { link } }')
        post("/mutate?commitNow=true",
             '{"set": [{"uid": "0x1", "name": "zz"}]}', "application/json")
        a.query_batch(['{ q(func: uid(0x1)) @recurse(depth: 3) '
                       '{ link } }'] * 4)
    finally:
        srv.shutdown()
        srv.server_close()
    facts = run().facts
    caches = memgov.GOVERNOR.registered_names(ever=True)
    print(json.dumps({
        "misses": runtime_misses(facts, locks=locks.MADE,
                                 metrics=METRICS.names(),
                                 spans=tracing.names()),
        "caches": sorted(caches),
        "inventory": sorted(x["name"] for x in facts["governed_caches"]),
        "counts": [len(locks.MADE), len(METRICS.names()),
                   len(tracing.names())]}))
""")


def test_facts_cover_a_cpu_run_of_the_port():
    """A fresh process serves HTTP queries, a mutation and a batch on the
    CPU; every lock name it made, metric and span name it recorded has a
    static site, and each cache it registered is inventoried."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CPU_RUN], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["misses"] == []
    assert set(doc["caches"]) <= set(doc["inventory"])
    assert all(n > 5 for n in doc["counts"]), doc["counts"]


def test_runtime_misses_reports_each_kind():
    facts = {"lock_classes": [{"name": "a.*"}], "metric_sites": [],
             "span_sites": [{"name": "s"}],
             "governed_caches": [{"name": "c1"}, {"name": "c2"}],
             "kernels": [{"name": "k", "route": "cuda", "source": "k.cu",
                          "launch_sites": []}]}
    got = runtime_misses(facts, locks={"a.x", "b"}, metrics={"m"},
                         spans={"s", "t"}, caches={"c1", "c3"},
                         launches={"k": 2, "idle": 0},
                         sources={"k": "k.cu"})
    assert got == ["lock 'b' has no static site",
                   "metric 'm' has no static site",
                   "span 't' has no static site",
                   "cache 'c3' registered but not in governed_caches",
                   "governed cache 'c2' never registered in this run",
                   "kernel 'k' launched 2 times but has no static launch "
                   "site"]
