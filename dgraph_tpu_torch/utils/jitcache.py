"""The governed memo of host-side derived objects.

Port of the `Memo` of `dgraph_tpu/utils/jitcache.py`, under the
reference's module name so that a reader finds the governed plan memo
where the reference keeps it. The rest of that module meters jax's jit
compiles and has no counterpart: the port's compiles are CUDA-graph
captures (`engine/fused.py`) and `nvcc` builds (`utils/kbuild.py`), which
record themselves in the cost profile.
"""

from __future__ import annotations

import collections

from dgraph_tpu_torch.utils import locks

__all__ = ["Memo"]


class Memo:
    """Bounded LRU memo for host-side derived objects that amortize like
    compiled programs do (batch PLANS keyed by query texts). Callers
    classify hits and misses into their own metrics; the memo only
    stores. Thread-safe.

    `governed=` names the memory-governor cache this memo registers as:
    the memo then accounts bytes per entry (`put(..., nbytes=,
    rebuild_us=)`) and surrenders its LRU-coldest entry on demand, priced
    at rebuild-µs per byte for the governor's cross-cache eviction
    order."""

    def __init__(self, name: str, capacity: int = 128,
                 governed: str | None = None, kind: str = "host"):
        self.name = name
        self.capacity = capacity
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._sizes: dict = {}
        self._costs: dict = {}
        self._bytes = 0
        self._lock = locks.make_lock(f"jitcache.memo.{name}")
        if governed is not None:
            from dgraph_tpu_torch.utils import memgov
            memgov.GOVERNOR.register(governed, kind, self.nbytes,
                                     self.evict_one,
                                     value_cb=self.coldest_value,
                                     owner=self)
        locks.guarded(self, "jitcache.memo.*")

    def get(self, key):
        with self._lock:
            if key not in self._d:
                return None
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value, nbytes: int | None = None,
            rebuild_us: float | None = None) -> None:
        """Insert (LRU-newest). `nbytes` is the entry's resident size
        (estimated when omitted) and `rebuild_us` what recomputing it
        costs — the governor evicts low rebuild-value-per-byte first."""
        if nbytes is None:
            from dgraph_tpu_torch.utils import memgov
            nbytes = memgov.estimate_nbytes(value)
        with self._lock:
            self._drop_locked(key)
            self._d[key] = value
            self._sizes[key] = int(nbytes)
            if rebuild_us is not None:
                self._costs[key] = float(rebuild_us)
            self._bytes += int(nbytes)
            while len(self._d) > self.capacity:
                k, _ = self._d.popitem(last=False)
                self._bytes -= self._sizes.pop(k, 0)
                self._costs.pop(k, None)

    def _drop_locked(self, key) -> None:
        if key in self._d:
            del self._d[key]
            self._bytes -= self._sizes.pop(key, 0)
            self._costs.pop(key, None)

    def reprice(self, key, rebuild_us: float) -> None:
        """Update an entry's rebuild cost after the fact."""
        with self._lock:
            if key in self._d:
                self._costs[key] = float(rebuild_us)

    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def evict_one(self) -> int:
        """Drop the LRU-coldest entry; returns bytes freed (0 = empty)."""
        with self._lock:
            if not self._d:
                return 0
            k, _ = self._d.popitem(last=False)
            freed = self._sizes.pop(k, 0)
            self._costs.pop(k, None)
            self._bytes -= freed
            return freed

    def coldest_value(self) -> float | None:
        """Recompute-µs-per-byte of the entry evict_one would drop."""
        with self._lock:
            if not self._d:
                return None
            k = next(iter(self._d))
            cost = self._costs.get(k)
            if cost is None:
                return None
            return cost / max(self._sizes.get(k, 1), 1)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._sizes.clear()
            self._costs.clear()
            self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
