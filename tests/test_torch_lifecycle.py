"""The port's request lifecycle against the reference's: deadlines,
cancellation and the request shell of `Alpha`.

The second half of the file is the harness the other lifecycle files
(`test_torch_{metrics,tracing,backup,maintenance,upsert,loaders}.py`)
share: `run_reference_case` runs one of the reference's own test
functions with every `dgraph_tpu.*` name it uses bound to the port's
counterpart (its module globals, and the modules it imports inside its
body through `sys.modules`), the port's `Alpha` and `Engine` on the CPU;
then again with the reference's own objects. Each run writes a
transcript — every `Alpha` query and mutation result, every backup
manifest and loader count, with the run's temp dir written as `<tmp>` —
and the two transcripts must be equal. Tolerance: exact.
"""

import contextlib
import dataclasses
import hashlib
import importlib
import inspect
import json
import re
import sys
import threading
import time
import types

import numpy as np
import pytest

import dgraph_tpu
import test_admission
from dgraph_tpu_torch.server.api import Alpha
from dgraph_tpu_torch.store.store import StoreBuilder
from dgraph_tpu_torch.store.schema import parse_schema
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.metrics import METRICS

REF, PORT = "dgraph_tpu", "dgraph_tpu_torch"

# -- the harness ---------------------------------------------------------------

_ALPHA_CALLS = ("query", "query_raw", "query_batch", "mutate", "upsert",
                "upsert_json", "commit_or_abort")
_RECORDED_FUNCS = {"backup", "backup_alpha", "restore", "verify_chain",
                   "run_bulk", "run_live", "export_rdf", "export_json",
                   "boot_from"}


class Transcript:
    """What a case's run said, with its temp dir written as <tmp>."""

    def __init__(self, tmp, caller=""):
        self.tmp = str(tmp)
        self.caller = caller     # the case's module
        self.log = []

    def add(self, kind, value):
        self.log.append((kind, self.norm(value)))

    def norm(self, v):
        text = _canon(v).replace(self.tmp, "<tmp>")
        if len(text) > 4096:
            return hashlib.sha256(text.encode()).hexdigest()
        return text


def _canon(v) -> str:
    """Canonical text of a result, built without recursion (a long
    shortest path nests one object per hop)."""
    out, stack = [], [v]
    while stack:
        x = stack.pop()
        if isinstance(x, _Tok):
            out.append(x.s)
        elif isinstance(x, dict):
            items = sorted(x.items(), key=lambda kv: str(kv[0]))
            seq = [_Tok("{")]
            for i, (k, y) in enumerate(items):
                seq += [_Tok(("," if i else "") + json.dumps(str(k)) + ":"),
                        y]
            seq.append(_Tok("}"))
            stack.extend(reversed(seq))
        elif isinstance(x, (list, tuple)):
            seq = [_Tok("[")]
            for i, y in enumerate(x):
                seq += ([_Tok(",")] if i else []) + [y]
            seq.append(_Tok("]"))
            stack.extend(reversed(seq))
        else:
            try:
                out.append(json.dumps(x))
            except TypeError:
                stack.append(_plain(x))
    return "".join(out)


class _Tok:
    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s


def _plain(v):
    if isinstance(v, bytes):
        return v.decode()
    if dataclasses.is_dataclass(v):
        return {k: x for k, x in dataclasses.asdict(v).items()
                if k != "elapsed_s"}
    if isinstance(v, np.generic):
        return v.item()
    if hasattr(v, "n_nodes") and hasattr(v, "uids"):
        return {"n_nodes": int(v.n_nodes)}
    if isinstance(v, (tuple, set)):
        return list(v)
    return repr(v)


def _recording_alpha(cls, tr: Transcript, cpu: bool):
    """`cls` with its calls' results written to `tr`; on the port, reads
    on the CPU. The port keeps no staged commits (a single node has
    none), so `_pending` reads as the reference's empty map."""

    def wrap(name):
        def call(self, *a, **kw):
            out = getattr(super(Rec, self), name)(*a, **kw)
            tr.add(name, out)
            return out
        return call

    ns = {n: wrap(n) for n in _ALPHA_CALLS if hasattr(cls, n)}
    if cpu:
        def __init__(self, *a, device="cpu", **kw):
            super(Rec, self).__init__(*a, device=device, **kw)

        @classmethod
        def open(klass, p_dir, *a, device="cpu", **kw):
            return super(Rec, klass).open(p_dir, *a, device=device, **kw)

        ns.update(__init__=__init__, open=open, _pending={})
    Rec = type(cls.__name__, (cls,), ns)
    return Rec


def _cpu_engine(cls):
    class CpuEngine(cls):
        def __init__(self, store, *a, device="cpu", **kw):
            super().__init__(store, *a, device=device, **kw)
    CpuEngine.__name__ = cls.__name__
    return CpuEngine


def _recorded(fn, tr: Transcript):
    """`fn`, its result written to `tr` when the case itself called it
    (the packages' own internal calls differ in where they import from)."""
    def call(*a, **kw):
        out = fn(*a, **kw)
        if sys._getframe(1).f_globals.get("__name__") == tr.caller:
            tr.add(fn.__name__, out)
        return out
    call.__name__ = fn.__name__
    return call


class _Proxy(types.ModuleType):
    """A module's names for one run. A name the case SETS (a module
    constant it lowers, a monkeypatch) is set on the real module too, so
    the module's own functions see it; a wrapped name stays wrapped."""

    def __setattr__(self, k, v):
        object.__setattr__(self, k, v)
        target = self.__dict__.get("_target")
        if target is not None and not k.startswith("__") and \
                k not in _WRAPPED and not isinstance(v, types.ModuleType):
            setattr(target, k, v)


_WRAPPED = {"Alpha", "Engine", *_RECORDED_FUNCS}


def _port_of(refname: str):
    """The port's counterpart of a reference module, or None (a module
    of a later item: the reference's own stays bound)."""
    try:
        return importlib.import_module(PORT + refname[len(REF):])
    except ModuleNotFoundError:
        return None


class _Binder:
    """Maps a package's objects for one run: for the port, each
    reference object to its port counterpart; for the reference, each to
    itself. Alpha, Engine and the recorded functions are wrapped."""

    def __init__(self, pkg, tr, extra=None):
        self.pkg, self.tr = pkg, tr
        self.extra = extra or {}
        self.proxies = {}
        self.orig = {}     # reference modules, resolved before any swap

    def ref_module(self, refname):
        if refname not in self.orig:
            self.orig[refname] = importlib.import_module(refname)
        return self.orig[refname]

    def module(self, refname):
        if refname in self.proxies:
            return self.proxies[refname]
        ref = self.ref_module(refname)
        src = _port_of(refname) if self.pkg == PORT else ref
        if src is None:
            self.proxies[refname] = ref
            return ref
        proxy = _Proxy(refname)
        proxy.__dict__.update(src.__dict__)
        proxy.__name__ = refname
        proxy.__dict__["_target"] = src
        self.proxies[refname] = proxy
        if self.pkg == PORT:
            # names the reference module re-exports from elsewhere
            for k, v in ref.__dict__.items():
                if k.startswith("__") or k in proxy.__dict__:
                    continue
                got = self.obj(v)
                if got is not v:
                    proxy.__dict__[k] = got
        for k, v in list(proxy.__dict__.items()):
            if k == "Alpha" and isinstance(v, type):
                proxy.__dict__[k] = self.alpha(v)
            elif k == "Engine" and isinstance(v, type) and \
                    self.pkg == PORT:
                proxy.__dict__[k] = _cpu_engine(v)
            elif k in _RECORDED_FUNCS and callable(v):
                proxy.__dict__[k] = _recorded(v, self.tr)
        proxy.__dict__.update(self.extra.get(refname, {}))
        return proxy

    def alpha(self, cls):
        key = ("alpha", cls)
        if key not in self.proxies:
            self.proxies[key] = _recording_alpha(cls, self.tr,
                                                 cpu=self.pkg == PORT)
        return self.proxies[key]

    def obj(self, v):
        """The run's counterpart of a reference object, or `v`."""
        if isinstance(v, types.ModuleType):
            n = v.__name__
            return self.module(n) if n.startswith(REF + ".") else v
        mod = getattr(v, "__module__", None)
        if isinstance(mod, str) and mod.startswith(REF + ".") and \
                (inspect.isclass(v) or inspect.isfunction(v)):
            # a name the port lacks (a later item's) stays the reference's
            return getattr(self.module(mod), v.__name__, v)
        # instances (METRICS): find the module-level name they bind
        for n in _REF_INSTANCES:
            for k, x in vars(self.ref_module(n)).items():
                if x is v and not k.startswith("_"):
                    return getattr(self.module(n), k)
        return v


_REF_INSTANCES = ("dgraph_tpu.utils.metrics", "dgraph_tpu.utils.memgov",
                  "dgraph_tpu.utils.costprofile",
                  "dgraph_tpu.utils.costprior")


def _ref_modules(module) -> list:
    src = inspect.getsource(module)
    names = set(re.findall(r"\bdgraph_tpu(?:\.\w+)+", src))
    out = []
    for n in sorted(names):
        while n.count("."):
            try:
                importlib.import_module(n)
                break
            except ImportError:
                n = n.rsplit(".", 1)[0]   # module.attr → module
        if n != REF:
            out.append(n)
    return sorted(set(out))


@contextlib.contextmanager
def bound(module, pkg, m, tr, extra=None):
    """`module`'s reference names bound to `pkg`'s objects for one run
    (undone by the monkeypatch context `m`)."""
    b = _Binder(pkg, tr, extra)
    names = _ref_modules(module)
    for n in (*names, *_REF_INSTANCES):
        b.ref_module(n)
    for n in names:
        proxy = b.module(n)
        if proxy is sys.modules.get(n):
            continue
        m.setitem(sys.modules, n, proxy)
        parent, _, child = n.rpartition(".")
        if parent in sys.modules:
            m.setattr(sys.modules[parent], child, proxy)
    for k, v in list(vars(module).items()):
        if k.startswith("__"):
            continue
        got = b.obj(v)
        if got is not v:
            m.setattr(module, k, got)
    yield b


def _fixture_fn(module, name):
    f = getattr(module, name, None)
    return getattr(f, "__wrapped__", None) if f is not None else None


def _resolve(fn, module, m, tmp, factory, cache, pkg, finalizers,
             fixtures=None):
    kw = {}
    for p in inspect.signature(fn).parameters:
        if p == "self":
            continue
        if fixtures and p in fixtures:
            kw[p] = fixtures[p]     # a pytest fixture the caller passes
        elif p == "tmp_path":
            tmp.mkdir(parents=True, exist_ok=True)
            kw[p] = tmp
        elif p == "monkeypatch":
            kw[p] = m
        elif p == "tmp_path_factory":
            kw[p] = factory
        else:
            key = (pkg, module.__name__, p)
            if key in cache:
                kw[p] = cache[key]
                continue
            ffn = _fixture_fn(module, p)
            assert ffn is not None, f"no fixture {p}"
            val = ffn(**_resolve(ffn, module, m, tmp, factory, cache, pkg,
                                 finalizers, fixtures))
            if inspect.isgenerator(val):
                gen, val = val, next(val)
                finalizers.append(gen)
            if isinstance(val, str):
                cache[key] = val   # module-scoped plain values (dirs)
            kw[p] = val
    return kw


def run_reference_case(module, name, pkg, tmp, monkeypatch, factory=None,
                       cache=None, after=None, extra=None,
                       fixtures=None) -> list:
    """Run `module.name` (a function, or `Class::method`) with `pkg`'s
    objects; returns the transcript. `after(tr)` may add to it;
    `fixtures` maps fixture names to values the caller supplies;
    `extra` maps module names to names bound in them, or is a function
    of (pkg, transcript) that returns that map."""
    tr = Transcript(tmp, module.__name__)
    if callable(extra):
        extra = extra(pkg, tr)
    finalizers = []
    with monkeypatch.context() as m:
        with bound(module, pkg, m, tr, extra):
            if "::" in name:
                cls_name, meth = name.split("::")
                fn = getattr(getattr(module, cls_name)(), meth)
            else:
                fn = getattr(module, name)
            try:
                fn(**_resolve(fn, module, m, tmp, factory,
                              cache if cache is not None else {}, pkg,
                              finalizers, fixtures))
                if after is not None:
                    after(tr)
            finally:
                for gen in finalizers:
                    with contextlib.suppress(StopIteration):
                        next(gen)
    return tr.log


def reference_cases(module, skip=()):
    """The module's test functions and test-class methods, by name."""
    out = []
    for n, obj in vars(module).items():
        if n.startswith("test_") and inspect.isfunction(obj):
            out.append(n)
        elif n.startswith("Test") and inspect.isclass(obj):
            out += [f"{n}::{k}" for k in vars(obj) if k.startswith("test_")]
    return [n for n in out if n.split("::")[-1] not in skip and n not in skip]


def compare_case(module, name, tmp_path, monkeypatch, factory=None,
                 cache=None, nondeterministic=(), after=None, extra=None):
    """Both runs of one case; their transcripts must be equal."""
    port = run_reference_case(module, name, PORT, tmp_path / "port",
                              monkeypatch, factory, cache, after, extra)
    ref = run_reference_case(module, name, REF, tmp_path / "ref",
                             monkeypatch, factory, cache, after, extra)
    if name.split("::")[-1] not in nondeterministic:
        assert port == ref
    return port


# -- test_admission.py's lifecycle cases on the port --------------------------

ADMISSION_CASES = ["test_deadline_cancels_pathological_query_promptly",
                   "test_cancel_flag_from_another_thread"]
# the cancel lands at whatever BFS iteration the other thread reached
ADMISSION_NONDET = {"test_cancel_flag_from_another_thread"}


def _warm_both():
    """Both packages serve the cases' small follow-up query once first:
    the case times it against 1 s, and a first call pays one-time costs
    (the reference's XLA compile, the port's first torch calls)."""
    import dgraph_tpu.server.api as ref_api
    q = "{ q(func: uid(0x1)) { uid link { uid } } }"
    n = test_admission.CHAIN_N    # programs are shaped by the store size
    _chain_alpha(n).query(q)
    ref_api.Alpha(base=test_admission._chain_store(n),
                  device_threshold=10**9).query(q)


@pytest.mark.parametrize("name", ADMISSION_CASES)
def test_admission_case_on_port(name, tmp_path, monkeypatch):
    _warm_both()
    compare_case(test_admission, name, tmp_path, monkeypatch,
                 nondeterministic=ADMISSION_NONDET)


# -- the port's own lifecycle checks ---------------------------------------------

def _chain_alpha(n=3000):
    b = StoreBuilder(parse_schema("link: [uid] @reverse .\nname: string ."))
    u = np.arange(1, n, dtype=np.int64)
    b.add_edges("link", u, u + 1)
    return Alpha(base=b.finalize(), device="cpu", device_threshold=10**9)


CHAIN_Q = ("{ path as shortest(from: 0x1, to: 0x%x, depth: %d) { link } "
           "p(func: uid(path)) { uid } }")


class _ExpiresAt(dl.RequestContext):
    """A budget that runs out when the request reaches `stage` (the
    clock moved without a sleep)."""

    def __init__(self, stage):
        super().__init__(60_000)
        self.target = stage

    def check(self, stage=""):
        if stage == self.target:
            self.consume(120.0)
        super().check(stage)


@pytest.mark.parametrize("stage,query,fused", [
    ("block", "{ q(func: uid(0x1)) { uid } }", "1"),
    ("bfs", CHAIN_Q % (3000, 3000), "1"),
    ("recurse", "{ q(func: uid(0x1)) @recurse(depth: 3000) { uid link } }",
     "0"),
    ("level", "{ q(func: uid(0x1)) { link { link { link { uid } } } } }",
     "0"),
    ("kernel", "{ q(func: uid(0x1)) { link { link { link { uid } } } } }",
     "1"),
    ("emit", "{ q(func: uid(0x1)) @recurse(depth: 50) { uid link } }",
     "1"),
])
def test_budget_raises_at_each_stage_and_leaks_nothing(
        stage, query, fused, monkeypatch):
    """A budget that runs out at a stage's checkpoint raises there,
    counted under that stage; nothing stays registered, no context is
    left on the thread, and the next request answers as an unbudgeted
    one does. `fused` turns whole-block programs on or off."""
    monkeypatch.setenv("DGRAPH_TPU_FUSED", fused)
    a = _chain_alpha()
    want = a.query_raw(query)
    before = METRICS.get("deadline_exceeded_total", stage=stage)
    with pytest.raises(dl.DeadlineExceeded) as ei:
        with dl.activate(_ExpiresAt(stage)):
            a.query_raw(query)
    assert ei.value.stage == stage
    assert METRICS.get("deadline_exceeded_total", stage=stage) == \
        before + 1
    assert a._active_reads == {} and dl.current() is None
    assert a.query_raw(query) == want


def test_budget_expiring_mid_bfs_stops_at_bfs():
    """A real budget expiring while the BFS runs stops it at a "bfs"
    checkpoint, well before the uncancelled run's end."""
    a = _chain_alpha(20_000)
    q = CHAIN_Q % (20_000, 20_000)
    t0 = time.perf_counter()
    full = a.query(q)
    uncancelled = time.perf_counter() - t0
    assert len(full["p"]) == 20_000
    t0 = time.perf_counter()
    with pytest.raises(dl.DeadlineExceeded) as ei:
        a.query(q, deadline_ms=100)
    assert ei.value.stage == "bfs"
    assert time.perf_counter() - t0 < max(0.5, uncancelled / 4)
    assert a._active_reads == {}


def test_nested_request_reuses_outer_budget():
    a = _chain_alpha(50)
    seen = []
    with a._request("read", 10_000) as outer:
        with a._request("read", 1) as inner:
            seen.append(inner is outer)
        txn = a.new_txn()
        txn.query("{ q(func: uid(0x1)) { uid } }")
        txn.discard()
    assert seen == [True] and dl.current() is None


def test_query_batch_and_mutate_take_deadlines():
    a = _chain_alpha(120)
    qs = ["{ q(func: uid(0x%x)) @recurse(depth: 60) { uid link } }" % i
          for i in range(1, 9)]
    want = a.query_batch(qs)
    ctx = dl.RequestContext(1)
    ctx.consume(1.0)
    with dl.activate(ctx):
        with pytest.raises(dl.DeadlineExceeded) as ei:
            a.query_batch(qs)
    assert ei.value.stage in ("kernel", "block", "recurse", "level")
    assert a.query_batch(qs) == want
    err0 = METRICS.get("query_errors_total", lane="mutate")
    with dl.activate(ctx):
        with pytest.raises(dl.DeadlineExceeded) as ei:
            a.mutate(set_nquads='_:x <name> "late" .')
    assert ei.value.stage == "commit"
    # the refused commit reached neither the WAL nor the store, and its
    # start_ts does not pin the gc watermark
    assert a.query('{ q(func: has(name)) { name } }') == {"q": []}
    assert a._open_txns == {}
    watermark = a.oracle.min_active_ts()
    assert watermark == a.oracle.read_only_ts()   # no txn is active
    a.mutate(set_nquads='_:x <name> "on time" .', deadline_ms=60_000)
    assert a.query('{ q(func: has(name)) { name } }') == \
        {"q": [{"name": "on time"}]}
    # an explicit budget does not count as an error; the expired one did
    # not reach the request shell's error count (it was nested in ctx)
    assert METRICS.get("query_errors_total", lane="mutate") == err0


def test_failed_serve_counts_query_errors_and_cancel_does_not():
    a = _chain_alpha(50)
    e0 = METRICS.get("query_errors_total", lane="read")
    with pytest.raises(ValueError):
        a.query("{ q(func: uid(0x1) { uid }")
    assert METRICS.get("query_errors_total", lane="read") == e0 + 1
    with pytest.raises(dl.DeadlineExceeded):
        a.query("{ q(func: uid(0x1)) { uid } }", deadline_ms=1e-9)
    assert METRICS.get("query_errors_total", lane="read") == e0 + 2
    c0 = METRICS.get("request_cancelled_total", stage="block")
    ctx = dl.RequestContext()
    ctx.cancel()

    def run():
        # a thread outside any request: query() opens its own context,
        # which this cancelled one replaces through activate
        with dl.activate(ctx):
            with pytest.raises(dl.Cancelled):
                a.query("{ q(func: uid(0x1)) { uid } }")
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert METRICS.get("request_cancelled_total", stage="block") == c0 + 1
    assert METRICS.get("query_errors_total", lane="read") == e0 + 2


def test_default_deadline_applies_without_an_explicit_one():
    a = _chain_alpha(20_000)
    a.default_deadline_ms = 5
    with pytest.raises(dl.DeadlineExceeded):
        a.query(CHAIN_Q % (20_000, 20_000))
    a.default_deadline_ms = 0.0
    assert len(a.query(CHAIN_Q % (200, 200))["p"]) == 200


def test_reference_package_untouched_by_the_harness(tmp_path, monkeypatch):
    """After a swapped run every reference name is its own again."""
    import dgraph_tpu.server.api as ref_api
    before = (sys.modules["dgraph_tpu.server.api"], ref_api.Alpha,
              test_admission.Alpha, dgraph_tpu.server.api)
    run_reference_case(test_admission,
                       "test_cancel_flag_from_another_thread", PORT,
                       tmp_path, monkeypatch)
    assert (sys.modules["dgraph_tpu.server.api"], ref_api.Alpha,
            test_admission.Alpha, dgraph_tpu.server.api) == before
