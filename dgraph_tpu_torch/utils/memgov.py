"""Process-wide memory governor: one budget over every byte-holding cache.

Port of `dgraph_tpu/utils/memgov.py`. Every cache that holds bytes registers a *name*
(from the static `GOVERNED_CACHES` inventory below), a byte-accounting
callback and an evict-one callback. Two budgets (`device`, `host`) with
high/low watermarks govern them: when resident bytes cross the high
watermark the governor evicts, cheapest-to-rebuild entry first (ordered
by predicted recompute value per byte), until bytes drop under the low
watermark. The device bytes are the sum of the registered tensors'
`numel() * element_size()`, not what the caching allocator reserves:
evicting drops references, and the allocator keeps the freed blocks for
reuse until `torch.cuda.empty_cache()` (called by `note_oom` before a
retry, see there).

On top of the budgets sits the allocation-failure lifecycle. A launch
site wraps its device work in `oom_retry(site, shape, fn)`: a classified
allocation failure (`is_alloc_failure`: `torch.cuda.OutOfMemoryError`,
`MemoryError`, or an injected `AllocFault`) triggers a synchronous
evict-to-low-watermark and ONE retry of the same launch. A second
failure is logged at warning with the site, the shape and the bytes, and
raises. Only a site with a degraded route on the same card
(`degrade=True`: `fused.program`, whose blocks the staged torch ops
serve) sticky-degrades the (site, shape) and raises `OomDegraded` for
that route; every other site hands the allocation error itself to the
caller, and nothing is served from the host in its place. Any other
exception passes through untouched: a failed launch, an illegal
address, a kernel build error or an assertion is never taken for an
allocation failure, and nothing catches it here. `set_alloc_fault` is
the process hook that injects allocation failures at the real launch
sites (consulted by `oom_retry` before each attempt).

`govern_dict` joins a cache held in an owner's dict to the registry
(oldest entry evicted first), and `Governor.add_dependent` lets a cache
whose entries pin another's tensors drop them when those are evicted.

Metrics, under the reference's names: `cache_evictions_total{cache=}`,
the `cache_resident_bytes{cache=}` gauge (set by `status()`),
`oom_events_total{site=}` and the `oom_degraded` gauge.
"""

from __future__ import annotations

import contextlib
import sys
import weakref

import torch

from dgraph_tpu_torch.utils import logging as xlog
from dgraph_tpu_torch.utils.device import DEVICE_WIDE
from dgraph_tpu_torch.utils.metrics import METRICS
from dgraph_tpu_torch.utils import locks

__all__ = [
    "GOVERNED_CACHES", "Governor", "GOVERNOR", "AllocFault", "OomDegraded",
    "is_alloc_failure", "set_alloc_fault", "check_alloc_fault", "oom_retry",
    "estimate_nbytes", "govern_dict", "HIGH_WATERMARK", "LOW_WATERMARK",
]

# The static inventory: every governed cache the port has, by name,
# the reference's `store.sharded` (mesh shard stacks) among them.
GOVERNED_CACHES: dict[str, str] = {
    "fused.program": "whole-block programs: captured CUDA graphs per "
                     "program key, charged the memory their capture "
                     "reserved (engine/fused.py)",
    "batch.plan": "batch plan memo: parsed+grouped plans keyed by query "
                  "texts, shared across identical batches",
    "batch.ell": "host ELL adjacency builds per (snapshot, pred, dir) — "
                 "the padded blocks the lane kernels consume",
    "batch.ell_dev": "device ELL adjacency (the tensors of batch.ell "
                     "entries on the card)",
    "batch.kernel": "recurse/step runners per launch configuration",
    "store.device": "per-relation CSR (indptr, indices) tensors placed "
                    "by Store.device_rel",
    "store.sharded": "mesh shard stacks placed by Store.sharded_rel: "
                     "per-(pred, direction) row-sharded CSR tensors on the "
                     "mesh's devices, charged their shards' bytes",
    "api.tablet": "pulled tablet cache: per-(pred, version, vocabulary "
                  "width) tablets fetched from other groups, each with "
                  "the host of its kernel caches (every Alpha "
                  "registers it; a single node never fills it)",
    "outofcore.resident": "LazyPreds resident tablets: out-of-core "
                          "postings faulted from disk under its own LRU",
    "store.vec": "float32vector embedding stacks placed by "
                 "Store.vec_device — the k-NN seed tablets; evicted "
                 "stacks re-place on next use",
    "timeseries.ring": "retained metrics history: the sampler daemon's "
                       "bounded ring of windowed points — under "
                       "pressure the oldest history is surrendered first",
}

# watermark fractions of the configured budget: eviction starts above
# HIGH and runs down to LOW (hysteresis so a single fill does not thrash)
HIGH_WATERMARK = 0.90
LOW_WATERMARK = 0.70


class AllocFault(RuntimeError):
    """Synthetic allocation failure raised by the injection hook — the
    stand-in for `torch.cuda.OutOfMemoryError`."""


class OomDegraded(RuntimeError):
    """A (site, shape) with a degraded route on the same card exhausted
    its one OOM retry and is now sticky-degraded; the caller serves it
    by that route."""

    def __init__(self, site: str, shape: str):
        super().__init__(f"oom-degraded: {site} shape={shape}")
        self.site = site
        self.shape = shape


def is_alloc_failure(exc: BaseException) -> bool:
    """Classify an exception as a device allocation failure, by TYPE:
    the injected `AllocFault`, python `MemoryError`, or the caching
    allocator's `torch.cuda.OutOfMemoryError`. No message is matched:
    any other CUDA error (a failed launch, an illegal address, which
    poison the context) and a kernel build failure are not allocation
    failures and must raise."""
    return isinstance(exc, (AllocFault, MemoryError,
                            torch.cuda.OutOfMemoryError))


# allocation-fault injection hook: a process-wide callback consulted at
# every launch site right before the device work; returning truthy (or
# raising) injects the fault.

_alloc_fault_cb = None


def set_alloc_fault(cb) -> None:
    """Install (or clear, with None) the allocation-fault hook. The hook
    receives the launch-site name and injects by returning truthy or
    raising itself; tests arm one-shot closures."""
    global _alloc_fault_cb
    _alloc_fault_cb = cb


def check_alloc_fault(site: str) -> None:
    cb = _alloc_fault_cb
    if cb is not None and cb(site):
        raise AllocFault(f"injected allocation failure at {site}")


class _Entry:
    __slots__ = ("name", "kind", "bytes_cb", "evict_one_cb", "value_cb",
                 "detail_cb", "owner_ref")

    def __init__(self, name, kind, bytes_cb, evict_one_cb, value_cb,
                 owner, detail_cb=None):
        self.name = name
        self.kind = kind
        self.bytes_cb = bytes_cb
        self.evict_one_cb = evict_one_cb
        self.value_cb = value_cb
        self.detail_cb = detail_cb
        self.owner_ref = weakref.ref(owner) if owner is not None else None

    def alive(self) -> bool:
        return self.owner_ref is None or self.owner_ref() is not None

    def bytes(self) -> int:
        try:
            return int(self.bytes_cb())
        except Exception:  # noqa: BLE001 — accounting of a dying owner
            return 0

    def value(self) -> float:
        """Predicted recompute µs per byte of the entry this cache would
        evict next — lower is cheaper to rebuild, so evicted first; a
        cache with no opinion (None) evicts before any priced one."""
        if self.value_cb is None:
            return 0.0
        try:
            v = self.value_cb()
        except Exception:  # noqa: BLE001
            return 0.0
        return 0.0 if v is None else float(v)

    def detail(self) -> list:
        """Per-resident rows for the status document (a vec cache's
        placed stacks with their dims); [] without a detail callback."""
        if self.detail_cb is None:
            return []
        try:
            return list(self.detail_cb())
        except Exception:  # noqa: BLE001
            return []


class Governor:
    """The process-wide cache registry and budget enforcer. Callbacks are
    always invoked OUTSIDE the governor lock (entries are snapshotted
    under it first), so a cache's own lock never orders against ours and
    an eviction never frees memory a running launch still reads: the
    cache drops its reference, the launch keeps its own."""

    def __init__(self):
        self._lock = locks.make_lock("memgov.governor")
        self._entries: dict[int, _Entry] = {}
        self._ever: set = set()      # every name registered so far
        self._next_id = 0
        self._budgets = {"device": 0, "host": 0}
        self._armed = False          # any budget set (lock-free fast path)
        self._evictions: dict[str, int] = {}
        self._oom_events = 0
        self._degraded: dict[tuple[str, str], int] = {}
        self._deg_lock = locks.make_lock("memgov.degraded")  # leaf lock
        self._dependents: dict[str, list] = {}
        locks.guarded(self, "memgov.governor")

    # -- registration -----------------------------------------------------

    def register(self, name: str, kind: str, bytes_cb, evict_one_cb,
                 value_cb=None, owner=None, detail_cb=None) -> int:
        """Join the registry. `name` must appear in GOVERNED_CACHES and
        `kind` is the budget it draws from ("device" | "host").
        `bytes_cb()` returns resident bytes; `evict_one_cb()` drops the
        cache's coldest entry and returns bytes freed (0 when empty);
        `value_cb()` prices that coldest entry in recompute-µs-per-byte.
        Per-instance caches pass `owner` so dead instances fall out of
        the registry via weakref."""
        if name not in GOVERNED_CACHES:
            raise ValueError(f"unknown governed cache {name!r} — add it "
                             f"to memgov.GOVERNED_CACHES")
        if kind not in ("device", "host"):
            raise ValueError(f"bad cache kind {kind!r}")
        e = _Entry(name, kind, bytes_cb, evict_one_cb, value_cb, owner,
                   detail_cb)
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            self._entries[rid] = e
            self._ever.add(name)
            self._prune_locked()
        return rid

    def add_dependent(self, name: str, cb) -> None:
        """`cb(value)` runs after an entry of cache `name` is evicted
        through `govern_dict`, with the entry's value, outside every
        lock: a cache whose entries pin that value's tensors drops them,
        or evicting it would free no memory."""
        with self._lock:
            self._dependents.setdefault(name, []).append(cb)

    def evicted(self, name: str, value) -> None:
        with self._lock:
            cbs = list(self._dependents.get(name, ()))
        for cb in cbs:
            cb(value)

    def unregister(self, rid: int) -> None:
        with self._lock:
            self._entries.pop(rid, None)

    def _prune_locked(self) -> None:
        dead = [k for k, e in self._entries.items() if not e.alive()]
        for k in dead:
            del self._entries[k]

    def registered_names(self, ever: bool = False) -> set:
        """The names of the live registrations, or with `ever` of every
        registration this process made (resets keep them)."""
        with self._lock:
            if ever:
                return set(self._ever)
            return {e.name for e in self._entries.values() if e.alive()}

    def _snapshot(self, kind=None) -> list:
        with self._lock:
            self._prune_locked()
            return [e for e in self._entries.values()
                    if e.alive() and (kind is None or e.kind == kind)]

    # -- budgets / accounting ---------------------------------------------

    def set_budgets(self, device_bytes: int = 0,
                    host_bytes: int = 0) -> None:
        """Configure the budgets (0 disarms a kind). Watermarks are
        fractions of the budget: evict above HIGH, down to LOW."""
        with self._lock:
            self._budgets["device"] = int(device_bytes)
            self._budgets["host"] = int(host_bytes)
        self._armed = bool(device_bytes or host_bytes)

    def budget(self, kind: str) -> int:
        return self._budgets[kind]

    def resident_bytes(self, kind: str) -> int:
        return sum(e.bytes() for e in self._snapshot(kind))

    def cache_bytes(self, kind: str | None = None) -> dict:
        """Resident bytes per cache name (of one kind, or all)."""
        out: dict[str, int] = {}
        for e in self._snapshot(kind):
            out[e.name] = out.get(e.name, 0) + e.bytes()
        return out

    def evictions(self) -> dict:
        """Evictions per cache name since the last reset."""
        with self._lock:
            return dict(self._evictions)

    # -- eviction ---------------------------------------------------------

    def maybe_evict(self, kind: str) -> int:
        """Cache fill hook: when the kind's budget is armed and resident
        bytes crossed the high watermark, evict down to the low one.
        Unarmed processes pay one attribute read. Call it with no cache
        lock held: the eviction callbacks take the caches' locks."""
        if not self._armed:
            return 0
        budget = self._budgets[kind]
        if not budget:
            return 0
        if self.resident_bytes(kind) <= int(budget * HIGH_WATERMARK):
            return 0
        return self.evict_to_low(kind)

    def evict_to_low(self, kind: str) -> int:
        """Synchronous eviction pass: drop entries — lowest recompute-
        value-per-byte across caches first, each cache surrendering its
        own coldest entry — until resident bytes fall under the low
        watermark (or nothing evictable remains). Returns bytes freed."""
        budget = self._budgets[kind]
        low = int(budget * LOW_WATERMARK) if budget else 0
        freed = 0
        while self.resident_bytes(kind) > low:
            candidates = [e for e in self._snapshot(kind) if e.bytes() > 0]
            if not candidates:
                break
            candidates.sort(key=lambda e: e.value())
            got = 0
            for e in candidates:
                got = int(e.evict_one_cb() or 0)
                if got > 0:
                    METRICS.inc("cache_evictions_total", cache=e.name)
                    with self._lock:
                        self._evictions[e.name] = (
                            self._evictions.get(e.name, 0) + 1)
                    freed += got
                    break
            if got <= 0:      # every candidate refused: no progress
                break
        return freed

    # -- pressure (admission integration) ---------------------------------

    def admission_pressure(self):
        """Sustained-pressure probe for admission (server/admission.py):
        a kind still above its high watermark AFTER an eviction pass has
        nothing left to shed but load. Returns the kind name, or None.
        Unarmed: one attribute read."""
        if not self._armed:
            return None
        for kind in ("device", "host"):
            budget = self._budgets[kind]
            if not budget:
                continue
            high = int(budget * HIGH_WATERMARK)
            if self.resident_bytes(kind) > high:
                self.evict_to_low(kind)
                if self.resident_bytes(kind) > high:
                    return kind
        return None

    # -- the allocation-failure lifecycle ---------------------------------

    def note_oom(self, site: str, shape: str, kind: str = "device") -> int:
        """One allocation failure observed at a launch site: count it,
        and synchronously evict the kind to its low watermark so the
        retry has room. Returns bytes freed.

        Freed is not released: the evicted tensors' blocks go back to
        the caching allocator, which keeps them reserved. Under a cap
        (`torch.cuda.set_per_process_memory_fraction`) or a full card
        the retry needs them returned, so a device pass ends with
        `torch.cuda.empty_cache()`."""
        with self._deg_lock:
            self._oom_events += 1
        METRICS.inc("oom_events_total", site=site)
        freed = self.evict_to_low(kind)
        if kind == "device" and torch.cuda.is_initialized():
            with DEVICE_WIDE:     # never while another thread captures
                torch.cuda.empty_cache()
        from dgraph_tpu_torch.utils import flightrec
        flightrec.emit("memory.oom", site=site, shape=str(shape),
                       freed_bytes=freed)
        return freed

    def degrade(self, site: str, shape: str) -> None:
        """Sticky-degrade a (site, shape) of a site with a degraded route
        on the same card: its one retry also failed, so every later
        request on the shape takes that route until `reset`."""
        with self._deg_lock:
            key = (site, str(shape))
            self._degraded[key] = self._degraded.get(key, 0) + 1
            n = len(self._degraded)
        METRICS.set_gauge("oom_degraded", float(n))
        from dgraph_tpu_torch.utils import flightrec
        flightrec.emit("memory.degrade", site=site, shape=str(shape))
        self._warn(site, shape, "this shape is served by its degraded "
                   "route on the same card until reset")

    def _warn(self, site: str, shape: str, outcome: str) -> None:
        """The warning of a failed retry: the site, the shape and the
        bytes the governor and the allocator hold."""
        allocated = (torch.cuda.memory_allocated()
                     if torch.cuda.is_initialized() else 0)
        xlog.get("memgov").warning(
            "allocation failed again after the evict-and-retry at %s "
            "shape=%s (governed device bytes %d, allocator bytes %d): %s",
            site, shape, self.resident_bytes("device"), allocated, outcome)

    def is_degraded(self, site: str, shape) -> bool:
        with self._deg_lock:
            return (site, str(shape)) in self._degraded

    def oom_stats(self) -> dict:
        """The reference's counts: each event is retried exactly once,
        so `retries` is the event count."""
        with self._deg_lock:
            return {"events": self._oom_events,
                    "retries": self._oom_events,
                    "degraded": len(self._degraded)}

    # -- introspection ----------------------------------------------------

    def status(self) -> dict:
        """Budgets and watermarks, per-cache resident bytes and
        evictions, the OOM lifecycle's counts and degraded shapes."""
        caches: dict[str, dict] = {}
        for e in self._snapshot():
            b = e.bytes()
            c = caches.setdefault(e.name, {"kind": e.kind, "bytes": 0,
                                           "registrants": 0})
            c["bytes"] += b
            c["registrants"] += 1
            d = e.detail()
            if d:
                c.setdefault("detail", []).extend(d)
        with self._lock:
            ev = dict(self._evictions)
            budgets = dict(self._budgets)
        for name, c in caches.items():
            c["evictions"] = ev.get(name, 0)
            METRICS.set_gauge("cache_resident_bytes", float(c["bytes"]),
                              cache=name)
        kinds = {}
        for kind in ("device", "host"):
            budget = budgets[kind]
            kinds[kind] = {
                "budget_bytes": budget,
                "high_bytes": int(budget * HIGH_WATERMARK),
                "low_bytes": int(budget * LOW_WATERMARK),
                "resident_bytes": sum(c["bytes"] for c in caches.values()
                                      if c["kind"] == kind),
            }
        with self._deg_lock:
            degraded = [{"site": s, "shape": sh, "count": n}
                        for (s, sh), n in sorted(self._degraded.items())]
            oom = {"events": self._oom_events,
                   "retries": self._oom_events}
        pressure = None
        for kind in ("device", "host"):
            k = kinds[kind]
            if k["budget_bytes"] and k["resident_bytes"] > k["high_bytes"]:
                pressure = kind
                break
        return {"budgets": kinds, "caches": caches,
                "oom": oom, "degraded": degraded,
                "pressure": pressure}

    def reset(self, full: bool = False) -> None:
        """Clear budgets, eviction/OOM counters and sticky degrades
        (registrations survive unless full=True — module-level memos
        register once at import)."""
        with self._lock:
            self._budgets = {"device": 0, "host": 0}
            self._evictions.clear()
            if full:
                self._entries.clear()
        self._armed = False
        with self._deg_lock:
            self._oom_events = 0
            self._degraded.clear()
        METRICS.set_gauge("oom_degraded", 0.0)


GOVERNOR = Governor()


def oom_retry(site: str, shape, fn, kind: str = "device",
              degrade: bool = False, retry: bool = True):
    """Run one device launch with the allocation-failure lifecycle: a
    classified allocation failure triggers evict-to-low-watermark and
    ONE retry of the same `fn`. A second one is logged at warning and
    raises: with `degrade` (a site whose degraded route runs on the same
    card) it sticky-degrades the (site, shape) and raises `OomDegraded`
    for that route, and a shape already degraded raises it at once;
    otherwise the allocation error itself goes to the caller. Without
    `retry` (a mesh program across processes, whose other ranks would
    not re-run it) the first failure is counted and raises. Any other
    exception passes through untouched."""
    if degrade and GOVERNOR.is_degraded(site, shape):
        raise OomDegraded(site, str(shape))
    try:
        check_alloc_fault(site)
        return fn()
    except Exception as e:
        if not is_alloc_failure(e):
            raise
        if not retry:
            GOVERNOR.note_oom(site, str(shape), kind=kind)
            raise
    GOVERNOR.note_oom(site, str(shape), kind=kind)
    try:
        check_alloc_fault(site)
        return fn()
    except Exception as e2:
        if not is_alloc_failure(e2):
            raise
        if degrade:
            GOVERNOR.degrade(site, str(shape))
            raise OomDegraded(site, str(shape)) from e2
        GOVERNOR._warn(site, str(shape), "the error goes to the caller")
        raise


def govern_dict(owner, attr: str, name: str, kind: str, lock=None,
                sizer=None, on_evict=None, detail_cb=None,
                nbytes=None) -> int:
    """Join `owner.<attr>`, a dict whose first entry is its coldest (one
    filled in first-use order, or an LRU), to the registry as cache
    `name`. The callbacks hold a weakref to `owner`, so a dropped owner
    falls out of the registry, and take `lock` (the lock the owner fills
    the dict under, if any). Bytes are `sizer(value)` summed
    (`estimate_nbytes` by default), or `nbytes(owner)` where the owner
    keeps its own count. Eviction pops the first entry; then
    `on_evict(owner, key, value)`, under the lock, settles the owner's
    own accounting and returns the bytes freed (`sizer(value)` without
    it), and the governor's dependents of `name` see the value outside
    the lock."""
    sizer = sizer or estimate_nbytes
    lock = lock if lock is not None else contextlib.nullcontext()
    ref = weakref.ref(owner)

    def resident():
        o = ref()
        if o is None:
            return 0
        if nbytes is not None:
            return nbytes(o)
        with lock:
            vals = list(getattr(o, attr).values())
        return sum(sizer(v) for v in vals)

    def evict_one():
        o = ref()
        if o is None:
            return 0
        with lock:
            d = getattr(o, attr)
            if not d:
                return 0
            key = next(iter(d))
            value = d.pop(key)
            freed = (on_evict(o, key, value) if on_evict is not None
                     else sizer(value))
        GOVERNOR.evicted(name, value)
        return freed

    def detail():
        o = ref()
        return detail_cb(o) if o is not None else []

    return GOVERNOR.register(name, kind, resident, evict_one, owner=owner,
                             detail_cb=detail if detail_cb else None)


def estimate_nbytes(value) -> int:
    """Byte size of a cached value: a tensor counts `numel() *
    element_size()` on whatever device it lives, arrays their `.nbytes`,
    containers and dataclasses sum their members, anything else costs
    `sys.getsizeof`. An estimator, not an audit — budgets only need
    relative truth."""
    seen_bytes = 0
    stack = [value]
    depth = 0
    while stack and depth < 4096:
        depth += 1
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            seen_bytes += v.numel() * v.element_size()
            continue
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            try:
                seen_bytes += int(nb)
                continue
            except (TypeError, ValueError):
                pass
        if isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif hasattr(v, "__dataclass_fields__"):
            stack.extend(getattr(v, f) for f in v.__dataclass_fields__)
        else:
            seen_bytes += sys.getsizeof(v, 64)
    return seen_bytes
