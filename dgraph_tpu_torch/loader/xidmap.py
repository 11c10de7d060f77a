"""External id → uid assignment.

Port of `dgraph_tpu/loader/xidmap.py`, the same code, with its
`xidmap.shard` / `xidmap.pool` locks.

Reference parity: `xidmap/xidmap.go` — a sharded map handing out uids for
blank-node / external ids during loads, backed by Zero's uid leases. Here a
lock-striped dict drawing ranges from `cluster.Oracle.assign_uids` (batch
leases, like the reference's lease chunking).
"""

from __future__ import annotations

from dgraph_tpu_torch.cluster.oracle import Oracle
from dgraph_tpu_torch.utils import locks

LEASE_CHUNK = 1024


class XidMap:
    def __init__(self, oracle: Oracle, shards: int = 16):
        self._oracle = oracle
        self._shards = [
            (locks.make_lock("xidmap.shard"), {}) for _ in range(shards)]
        self._pool_lock = locks.make_lock("xidmap.pool")
        self._pool: list[int] = []
        locks.guarded(self, "xidmap.pool")

    def _lease(self) -> int:
        with self._pool_lock:
            if not self._pool:
                # reversed so pop() hands uids out ASCENDING: monotone
                # allocation keeps ranks append-only, which downstream
                # caches (foreign-tablet adaptation) rely on for validity
                self._pool = list(reversed(
                    self._oracle.assign_uids(LEASE_CHUNK)))
            return self._pool.pop()

    def assign(self, xid: str) -> int:
        """uid for external id, allocating on first sight
        (reference: XidMap.AssignUid)."""
        lock, m = self._shards[hash(xid) % len(self._shards)]
        with lock:
            uid = m.get(xid)
            if uid is None:
                uid = self._lease()
                m[xid] = uid
            return uid

    def resolve(self, ref: str) -> int:
        """Resolve a subject/object reference from a mutation: hex uid
        ("0x1f"), decimal, or external/blank id."""
        if ref.startswith("0x") or ref.startswith("0X"):
            return int(ref, 16)
        if ref.isdigit():
            return int(ref)
        return self.assign(ref)
