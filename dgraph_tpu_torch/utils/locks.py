"""Lock-order and race sanitizers: instrumented locks for the port.

Port of `dgraph_tpu/utils/locks.py`. Every lock of `dgraph_tpu_torch`
is made here, by `make_lock(name)` / `make_rlock` / `make_condition`,
under the reference's name for the same site (`mvcc.store`,
`admission.read`, ...) and, for the port's own locks, a name of its own
(`device.wide`, `store.place`, `kbuild.build`, ...). With the switches
off each constructor returns a plain `threading` primitive. The switches
keep the reference's names and are read when a lock is MADE, so a
process that wants them sets them before it imports the port (module
locks are made at import):

* `DGRAPH_TPU_LOCK_SANITIZER=1` — traced locks. When a thread takes
  lock B while holding lock A, the edge A→B enters a process-global
  graph keyed by lock NAME, with the acquisition stack of its first
  sighting; `GRAPH.cycles()` reports every order cycle with the stack
  of each edge. A lock held longer than `DGRAPH_TPU_LOCK_HOLD_MS`
  (default 250) is recorded with its release stack (`/debug/locks`),
  never failed on. Reentrant acquisition of one RLock records no
  self-edge, and same-name edges between distinct instances are
  skipped: the instances of one site form one order class. A release
  from another thread than the acquirer is tolerated and unrecorded.
* `DGRAPH_TPU_RACE_SANITIZER=1` (needs the lock sanitizer: the
  locksets are the traced locks' bookkeeping) — the Eraser lockset
  check. `guarded(obj, lock_name)`, called at the end of `__init__` of
  each class with a lock discipline, swaps the instance onto a cached
  subclass whose guarded fields are data descriptors. Every access
  runs the Eraser state machine per field:

      virgin → exclusive (first thread; the init window, no checks)
             → shared (a second thread reads)     C(v) ∩= held
             → shared-modified (any later write)  C(v) ∩= held, and an
               EMPTY C(v) here is a data race, reported with BOTH
               access stacks.

  The guarded fields of a class come from the port's static analysis
  (`analysis/guards.py: runtime_inventory`, rules R9-R12): the fields a
  class writes under one of its locks at three quarters or more of
  their access sites, less those whose unguarded access carries a
  reasoned `guarded-field` waiver. Direct field peeks from test frames
  are exempt (the harness checks internals at quiescent points). Off,
  `guarded()` returns at once and the fields are plain attributes.

This module imports nothing of the port (metrics and tracing make their
locks through it), and the instrumented fast path never calls back into
metrics.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

__all__ = ["enabled", "make_lock", "make_rlock", "make_condition", "MADE",
           "GRAPH", "LockGraph", "TracedLock", "TracedRLock",
           "set_enabled", "race_enabled", "guarded", "attach",
           "RACES", "RaceTable", "set_race_enabled"]

ENV_SWITCH = "DGRAPH_TPU_LOCK_SANITIZER"
ENV_RACE_SWITCH = "DGRAPH_TPU_RACE_SANITIZER"
ENV_HOLD_MS = "DGRAPH_TPU_LOCK_HOLD_MS"
MAX_LONG_HOLDS = 64          # bounded report ring — newest wins
MAX_RACE_REPORTS = 64        # bounded race list — first wins (root cause)
_STACK_SKIP = 2              # drop the sanitizer's own frames


def enabled() -> bool:
    """Is the sanitizer armed for NEW locks? (Checked at lock-creation
    time: flipping the env var mid-process affects locks made after.)"""
    return os.environ.get(ENV_SWITCH, "") not in ("", "0")


def _stack() -> str:
    return "".join(traceback.format_stack()[:-_STACK_SKIP])


def _frames() -> tuple:
    """The stack `_stack` prints, as raw (file, line, function) frames,
    innermost last: taken without reading a source file. The race table
    keeps one at every state change of a field, on the request path of
    whichever thread touches it, and renders it (`_render`) only into a
    report; formatting there reads every frame's file (a `stat` each,
    through `linecache`), milliseconds a change on a loaded host."""
    out = []
    f = sys._getframe(_STACK_SKIP)
    while f is not None:
        out.append((f.f_code.co_filename, f.f_lineno, f.f_code.co_name,
                    None))
        f = f.f_back
    out.reverse()
    return tuple(out)


def _render(frames: tuple) -> str:
    return "".join(traceback.StackSummary.from_list(frames).format())


class LockGraph:
    """Process-global acquisition-order graph + long-hold ring.

    Thread-held stacks live in a `threading.local`; the graph structure
    is guarded by a PLAIN lock (never a traced one — the sanitizer must
    not sanitize itself) that is only taken on the slow paths: first
    sighting of an edge, a long hold, a snapshot."""

    def __init__(self, hold_threshold_ms: float | None = None):
        self._glock = threading.Lock()
        self._tls = threading.local()
        if hold_threshold_ms is None:
            hold_threshold_ms = float(
                os.environ.get(ENV_HOLD_MS, "") or 250.0)
        self.hold_threshold_s = hold_threshold_ms / 1e3
        # (held_name, acquired_name) → {"count", "stack"} — stack is the
        # first-sighting acquisition stack of the SECOND lock
        self.edges: dict[tuple[str, str], dict] = {}
        self.long_holds: list[dict] = []
        self.acquires = 0            # total instrumented acquisitions
        self.recording = True

    def set_enabled(self, flag: bool) -> None:
        """Disarm recording (the <5% overhead guard's off switch).
        Already-held entries release tolerantly while disarmed."""
        self.recording = bool(flag)

    # -- hot path ------------------------------------------------------------
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def note_acquire(self, lock) -> None:
        """Called AFTER the inner primitive was acquired."""
        if not self.recording:
            return
        held = self._held()
        self.acquires += 1
        reentrant = any(e[0] is lock for e in held)
        if not reentrant and held:
            seen_names = set()
            for entry in held:
                a = entry[0].name
                b = lock.name
                if a == b or a in seen_names:
                    continue
                seen_names.add(a)
                key = (a, b)
                e = self.edges.get(key)   # racy read: fine, edge keys
                if e is not None:         # are write-once + count bump
                    e["count"] += 1
                else:
                    with self._glock:
                        if key not in self.edges:
                            self.edges[key] = {"count": 1,
                                               "stack": _stack()}
                        else:
                            self.edges[key]["count"] += 1
        held.append((lock, time.monotonic(), reentrant))
        # bump the per-thread held-set version (the race sanitizer
        # caches its lockset-by-name off it — one int add here saves
        # a frozenset build per tracked field access over there)
        self._tls.ver = getattr(self._tls, "ver", 0) + 1

    def note_release(self, lock) -> None:
        held = getattr(self._tls, "held", None)
        if not held:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                _, t0, _reent = held.pop(i)
                self._tls.ver = getattr(self._tls, "ver", 0) + 1
                if not self.recording:
                    return
                dt = time.monotonic() - t0
                if dt >= self.hold_threshold_s:
                    with self._glock:
                        if len(self.long_holds) >= MAX_LONG_HOLDS:
                            self.long_holds.pop(0)
                        self.long_holds.append(
                            {"lock": lock.name,
                             "held_ms": round(dt * 1e3, 3),
                             "stack": _stack()})
                return
        # unmatched release (cross-thread hand-off, or recording was
        # off at acquire time): tolerated, see module docstring

    # -- reporting -----------------------------------------------------------
    def cycles(self) -> list[dict]:
        """Every distinct lock-order cycle in the recorded graph, each
        with the acquisition stack of EVERY participating edge. Empty
        list == no inversion was ever observed."""
        with self._glock:
            edges = {k: dict(v) for k, v in self.edges.items()}
        adj: dict[str, list[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
        out, seen_cycles = [], set()

        def dfs(node: str, path: list[str], on_path: set):
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):]
                    key = frozenset(cyc)
                    if key in seen_cycles:
                        continue
                    seen_cycles.add(key)
                    ring = cyc + [nxt]
                    out.append({
                        "cycle": cyc,
                        "edges": [
                            {"from": ring[i], "to": ring[i + 1],
                             "count": edges[(ring[i],
                                             ring[i + 1])]["count"],
                             "stack": edges[(ring[i],
                                             ring[i + 1])]["stack"]}
                            for i in range(len(cyc))],
                    })
                elif nxt not in visited:
                    visited.add(nxt)
                    on_path.add(nxt)
                    dfs(nxt, path + [nxt], on_path)
                    on_path.discard(nxt)

        visited: set[str] = set()
        for start in sorted(adj):
            if start not in visited:
                visited.add(start)
                dfs(start, [start], {start})
        return out

    def snapshot(self) -> dict:
        """Graph + long-hold state for `/debug/locks` (stacks trimmed
        to their last line for the edge table; cycles keep full ones)."""
        with self._glock:
            edges = [{"from": a, "to": b, "count": e["count"]}
                     for (a, b), e in sorted(self.edges.items())]
            holds = list(self.long_holds)
        return {
            "enabled": enabled(),
            "recording": self.recording,
            "acquires_total": self.acquires,
            "edges": edges,
            "cycles": self.cycles(),
            "long_holds": [{k: v for k, v in h.items() if k != "stack"}
                           for h in holds],
            "hold_threshold_ms": self.hold_threshold_s * 1e3,
        }

    def reset(self) -> None:
        """Test hook: forget edges and holds (held stacks survive — a
        reset under live threads must not orphan their releases)."""
        with self._glock:
            self.edges.clear()
            self.long_holds.clear()
            self.acquires = 0


GRAPH = LockGraph()


def set_enabled(flag: bool) -> None:
    GRAPH.set_enabled(flag)


class TracedLock:
    """`threading.Lock` plus order/hold recording. Supports the full
    acquire signature so `threading.Condition` can wrap it."""

    __slots__ = ("_inner", "name", "_graph")
    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str, graph: LockGraph | None = None):
        self._inner = self._factory()
        self.name = name
        self._graph = graph if graph is not None else GRAPH

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._graph.note_acquire(self)
        return ok

    def release(self) -> None:
        self._graph.note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} {self._inner!r}>"


class TracedRLock(TracedLock):
    """Reentrant flavor: nested acquisition by the owner records no
    self-edge (note_acquire detects the instance already on the held
    stack) and hold time measures the OUTERMOST span."""

    __slots__ = ()
    _factory = staticmethod(threading.RLock)

    def locked(self) -> bool:  # RLock has no locked() before 3.12
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


# every order-class name a constructor below was called with in this
# process (chip_smoke.py holds them against the static lock classes)
MADE: set = set()


def make_lock(name: str) -> "threading.Lock | TracedLock":
    """The one lock constructor every subsystem uses: a plain
    `threading.Lock` in production, a `TracedLock` under the sanitizer.
    `name` is the site's order-class (e.g. "mvcc.store")."""
    MADE.add(name)
    return TracedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str) -> "threading.RLock | TracedRLock":
    MADE.add(name)
    return TracedRLock(name) if enabled() else threading.RLock()


def make_condition(name: str) -> threading.Condition:
    """A Condition whose underlying lock participates in the order
    graph (wait() releases/reacquires through the traced wrapper)."""
    MADE.add(name)
    if enabled():
        return threading.Condition(TracedLock(name))
    return threading.Condition()


# ---------------------------------------------------------------------------
# Eraser lockset race sanitizer — see module docstring

def race_enabled() -> bool:
    """Is the race sanitizer armed for NEW guarded() calls? Requires
    the lock sanitizer too: the per-thread lockset IS TracedLock's
    held bookkeeping — without it every lockset reads empty and every
    shared field would convict."""
    return (os.environ.get(ENV_RACE_SWITCH, "") not in ("", "0")
            and enabled())


# Eraser field states
_EXCLUSIVE, _SHARED, _SHARED_MOD = 0, 1, 2
_STATE_KEY = "_race_state"   # per-instance {field: state dict}


class _RaceField:
    """Data descriptor standing in for ONE tracked field on a shim
    subclass: every get/set records the access, then reads/writes the
    plain value in the instance dict (a data descriptor shadows the
    instance dict, so storage and interception never recurse).
    Untracked attributes of the same object ride the normal lookup
    path untouched."""

    __slots__ = ("name", "table")

    def __init__(self, name: str, table: "RaceTable"):
        self.name = name
        self.table = table

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        self.table.note(obj, self.name, False)
        try:
            return obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value):
        self.table.note(obj, self.name, True)
        obj.__dict__[self.name] = value

    def __delete__(self, obj):
        self.table.note(obj, self.name, True)
        del obj.__dict__[self.name]


class RaceTable:
    """Per-field Eraser lockset state machine + the bounded report
    list. Field state lives ON the instance (`_race_state` dict) so
    object death retires its state — id() reuse can never alias two
    objects' histories into a false race. The report path is the only
    slow path; candidate-set updates are dict ops under the GIL, and
    a torn update can only MISS an intersection (a report requires
    two real accesses with disjoint locksets, which is a discipline
    violation by itself — no false positive is constructible)."""

    def __init__(self, graph: LockGraph | None = None,
                 exempt_tests: bool = False):
        self._glock = threading.Lock()  # reports/registry, never hot
        self.graph = graph if graph is not None else GRAPH
        self.reports: list[dict] = []
        self.races_total = 0
        self.recording = True
        # the process-global table skips direct field peeks from test
        # frames (see note()); private tables in synthetic race tests
        # must check EVERY access, including the test's own
        self.exempt_tests = exempt_tests
        # original class -> shim subclass; (file, class) -> arming info
        self._shims: dict = {}
        self.registered: dict = {}
        # per-thread token: threading.get_ident() RECYCLES after a
        # thread exits, which would let a later thread alias a dead
        # owner and park a field in the exclusive state (a missed
        # race); these tokens are issued once per thread lifetime and
        # never reused
        self._tok_tls = threading.local()
        self._tok_iter = iter(range(1, 1 << 62))

    def _tid(self) -> int:
        t = getattr(self._tok_tls, "tok", None)
        if t is None:
            t = self._tok_tls.tok = next(self._tok_iter)
        return t

    def set_enabled(self, flag: bool) -> None:
        """Disarm recording (the <5% overhead guard's off switch) —
        descriptors stay installed; note() returns immediately."""
        self.recording = bool(flag)

    # -- hot path -------------------------------------------------------------
    _EMPTY = frozenset()

    def _held_names(self) -> frozenset:
        """The calling thread's held lockset by name, cached against
        the graph's per-thread acquire/release version — a lock
        section with several tracked accesses builds the set once."""
        tls = self.graph._tls
        held = getattr(tls, "held", None)
        if not held:
            return self._EMPTY
        ver = getattr(tls, "ver", 0)
        cache = getattr(tls, "names_cache", None)
        if cache is not None and cache[0] == ver:
            return cache[1]
        names = frozenset(e[0].name for e in held)
        tls.names_cache = (ver, names)
        return names

    def _from_test(self) -> bool:
        """Harness exemption (global table only): a DIRECT field peek
        from test code (the fuzz harness asserting `not a._pending`
        at a quiescent point) is instrumentation, not package
        discipline — package-internal accesses triggered BY tests
        still have package frames at the access site and stay fully
        checked. Only consulted when an access is about to CHANGE
        state or report, so the steady-state hot path never walks a
        frame."""
        caller = sys._getframe(3).f_code.co_filename
        return "/tests/" in caller or caller.endswith("conftest.py")

    def note(self, obj, field: str, write: bool) -> None:
        if not self.recording:
            return
        tid = self._tid()
        states = obj.__dict__.get(_STATE_KEY)
        if states is None:
            states = obj.__dict__[_STATE_KEY] = {}
        s = states.get(field)
        if s is None:
            if self.exempt_tests and self._from_test():
                return
            # first tracked access: exclusive to this thread, no
            # checks — Eraser's initialization window. Its stack is
            # kept: it is "the other side" of a race surfacing at the
            # very first cross-thread write.
            states[field] = {"mode": _EXCLUSIVE, "owner": tid,
                             "set": None, "stack": _frames(),
                             "stack_tid": tid, "stack_held": (),
                             "reported": False}
            return
        mode = s["mode"]
        if mode == _EXCLUSIVE:
            if s["owner"] == tid:
                return  # fast path: still single-threaded
            if self.exempt_tests and self._from_test():
                return
            # second thread arrives: leave the init window
            held = self._held_names()
            s["set"] = held
            s["mode"] = _SHARED_MOD if write else _SHARED
            if s["mode"] == _SHARED_MOD and not held \
                    and not s["reported"]:
                self._report(obj, field, s, tid, held, write)
                return
            s["stack"] = _frames()
            s["stack_tid"] = tid
            s["stack_held"] = tuple(sorted(held))
            return
        held = self._held_names()
        new = s["set"] & held
        flip = write and mode == _SHARED
        if new == s["set"] and not flip:
            # steady state — nothing would change; the only possible
            # event is an access racing an already-empty set
            if mode == _SHARED_MOD and not new and not s["reported"]:
                if self.exempt_tests and self._from_test():
                    return
                self._report(obj, field, s, tid, held, write)
            return
        # a shrink and/or the shared→shared-modified flip is imminent:
        # now (and only now) pay the harness-exemption frame walk
        if self.exempt_tests and self._from_test():
            return
        if flip:
            s["mode"] = _SHARED_MOD
        shrank = new != s["set"]
        if shrank:
            s["set"] = new
        if s["mode"] == _SHARED_MOD and not new and not s["reported"]:
            self._report(obj, field, s, tid, held, write)
            return
        if shrank:
            # this access shrank the candidate set: it is one of the
            # two accesses that prove any upcoming race
            s["stack"] = _frames()
            s["stack_tid"] = tid
            s["stack_held"] = tuple(sorted(held))

    # -- reporting ------------------------------------------------------------
    def _report(self, obj, field, s, tid, held, write) -> None:
        s["reported"] = True  # one report per field, not a flood
        with self._glock:
            self.races_total += 1
            if len(self.reports) >= MAX_RACE_REPORTS:
                return
            self.reports.append({
                "class": type(obj).__name__,
                "field": field,
                "lock": getattr(type(obj), "_race_lock_", "?"),
                "kind": "write" if write else "read",
                "first": {"thread": s["stack_tid"],
                          "lockset": list(s["stack_held"]),
                          "stack": _render(s["stack"])},
                "second": {"thread": tid,
                           "lockset": sorted(held),
                           "stack": _stack()},
            })

    def snapshot(self) -> dict:
        with self._glock:
            reports = [dict(r) for r in self.reports]
            tracked = sorted(f"{file}:{cls}"
                             for file, cls in self.registered)
        return {
            "enabled": race_enabled(),
            "recording": self.recording,
            "races_total": self.races_total,
            "tracked_classes": tracked,
            "reports": reports,
        }

    def reset(self) -> None:
        """Test hook: forget reports (shims and per-object state
        survive — live objects keep their histories)."""
        with self._glock:
            self.reports.clear()
            self.races_total = 0

    # -- arming ---------------------------------------------------------------
    def attach(self, obj, fields, lock_name: str) -> None:
        """Install the field-access shim on one instance: swap its
        class for a cached subclass carrying a _RaceField descriptor
        per tracked field. Values already in the instance dict stay
        where they are — the descriptor reads/writes the same slot."""
        cls = type(obj)
        if getattr(cls, "_race_shim_", False):
            return  # already armed (re-registration is a no-op)
        sub = self._shims.get((cls, tuple(fields)))
        if sub is None:
            ns = {f: _RaceField(f, self) for f in fields}
            ns["_race_shim_"] = True
            ns["_race_lock_"] = lock_name
            sub = type(cls.__name__, (cls,), ns)
            with self._glock:
                self._shims.setdefault((cls, tuple(fields)), sub)
                sub = self._shims[(cls, tuple(fields))]
        obj.__class__ = sub

    def register(self, obj, lock_name: str) -> None:
        """The `guarded()` slow path: resolve the statically-inferred
        field inventory for this object's class (walking the MRO —
        `WAL(Journal)` arms Journal's fields) and attach the shim."""
        from dgraph_tpu_torch.analysis.guards import runtime_inventory
        inv = runtime_inventory()
        fields: list = []
        hit_key = None
        for klass in type(obj).__mro__:
            mod = getattr(klass, "__module__", "") or ""
            if not mod.startswith("dgraph_tpu_torch"):
                continue
            key = (mod.replace(".", "/") + ".py", klass.__name__)
            entry = inv.get(key)
            if entry is None:
                continue
            hit_key = hit_key or key
            for info in entry["locks"].values():
                fields.extend(f for f in info["fields"]
                              if f not in fields)
        if hit_key is None:
            return  # no inferred discipline: nothing to arm
        with self._glock:
            self.registered[hit_key] = {
                "lock": lock_name, "fields": tuple(sorted(fields))}
        self.attach(obj, fields, lock_name)


RACES = RaceTable(exempt_tests=True)


def set_race_enabled(flag: bool) -> None:
    RACES.set_enabled(flag)


def attach(obj, fields, lock_name: str,
           table: RaceTable | None = None) -> None:
    """Test-facing shim installer with an explicit field list and an
    optional private table (synthetic races must not trip the
    suite's gate)."""
    (table if table is not None else RACES).attach(
        obj, tuple(fields), lock_name)


def guarded(obj, lock_name: str):
    """Arm one instance for Eraser lockset checking, using the
    statically-inferred guarded-field inventory for its class. Called
    once at the end of `__init__` by every class the inventory lists;
    a PLAIN no-op (and plain attributes) unless
    DGRAPH_TPU_RACE_SANITIZER=1 and the lock sanitizer is armed.
    Returns `obj` so call sites can wrap construction."""
    if race_enabled():
        RACES.register(obj, lock_name)
    return obj
