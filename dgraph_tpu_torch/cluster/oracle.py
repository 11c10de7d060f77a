"""The cluster Oracle: timestamps, uid leases, commit arbitration.

Port of `dgraph_tpu/cluster/oracle.py`, the same code, with its
`oracle.state` lock (`utils/locks`). Reference parity: Zero's oracle
(`dgraph/cmd/zero/oracle.go` — Timestamps,
commit with conflict checks, MaxAssigned watermark) and uid leasing
(`zero.Server.AssignUids`, `dgraph/cmd/zero/assign.go`). In the reference
this state machine is replicated via group-0 Raft; here it is a single
authority object the Alpha process owns (multi-node replication of the
oracle is a host-side concern, deliberately outside the TPU data path —
SURVEY §2.3: Zero never touches posting data).

Transaction model (snapshot isolation, first-committer-wins):
- `read_ts()` issues a fresh start timestamp; a txn reads the snapshot of
  everything committed at or before it.
- Each mutation produces *conflict keys* (predicate+subject, and index
  tokens for indexed values — reference: `posting.addConflictKeys`).
- `commit(start_ts, keys)` aborts iff any key was committed by another txn
  after `start_ts`; otherwise assigns the next commit timestamp.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

from dgraph_tpu_torch.utils import locks


class TxnAborted(Exception):
    """Raised on commit conflict (reference: pb.TxnContext.Aborted)."""


def fingerprint(key) -> str:
    """Deterministic cross-process conflict-key fingerprint. Python's
    hash() is salted per process, which both risks collisions and makes
    keys unshareable between nodes; sha1 hex is stable and collision-free
    for distinct keys (reference: farm fingerprints on posting keys)."""
    return hashlib.sha1(str(key).encode()).hexdigest()


@dataclass
class TxnStatus:
    start_ts: int
    commit_ts: int  # 0 while pending, -1 if aborted
    created: float = field(default_factory=time.monotonic)


class Oracle:
    """Timestamp + uid authority with commit conflict detection."""

    def __init__(self, first_ts: int = 1, first_uid: int = 1):
        self._lock = locks.make_lock("oracle.state")
        self._next_ts = first_ts
        self._next_uid = first_uid
        self._pending: dict[int, TxnStatus] = {}
        # sha1 fingerprint of conflict key → commit_ts of the last writer
        self._commits: dict[str, int] = {}
        self._max_assigned = first_ts - 1
        locks.guarded(self, "oracle.state")

    # -- timestamps ---------------------------------------------------------
    def read_ts(self) -> int:
        """New start timestamp for a TRANSACTION — tracked as pending until
        commit/abort (reference: Zero.Timestamps lease)."""
        with self._lock:
            ts = self._next_ts
            self._next_ts += 1
            self._pending[ts] = TxnStatus(start_ts=ts, commit_ts=0)
            self._max_assigned = max(self._max_assigned, ts)
            return ts

    def read_only_ts(self) -> int:
        """Timestamp for a one-shot read — not tracked, so it never blocks
        the gc watermark (reference: best-effort/read-only queries)."""
        with self._lock:
            ts = self._next_ts
            self._next_ts += 1
            self._max_assigned = max(self._max_assigned, ts)
            return ts

    @property
    def max_assigned(self) -> int:
        """Watermark below which all timestamps are decided
        (reference: pb.OracleDelta.MaxAssigned)."""
        with self._lock:
            return self._max_assigned

    def min_active_ts(self) -> int:
        """Oldest start_ts an undecided txn still reads at — the snapshot
        retention watermark (reference: oracle doneUntil)."""
        with self._lock:
            active = [st.start_ts for st in self._pending.values()
                      if st.commit_ts == 0]
            return min(active) if active else self._next_ts

    def gc(self) -> int:
        """Drop decided txn records and conflict entries no active txn can
        collide with; returns the min-active watermark."""
        with self._lock:
            active = [st.start_ts for st in self._pending.values()
                      if st.commit_ts == 0]
            floor = min(active) if active else self._next_ts
            self._pending = {ts: st for ts, st in self._pending.items()
                             if st.commit_ts == 0}
            self._commits = {k: c for k, c in self._commits.items()
                             if c > floor}
            return floor

    # -- uid leases ---------------------------------------------------------
    def assign_uids(self, n: int) -> range:
        """Lease `n` fresh uids (reference: zero assign.go AssignUids)."""
        if n <= 0:
            raise ValueError("need n > 0 uids")
        with self._lock:
            lo = self._next_uid
            self._next_uid += n
            return range(lo, lo + n)

    def bump_ts(self, ts: int) -> None:
        """Ensure future timestamps start above a replayed commit_ts
        (reference: oracle restore from raft snapshot + WAL)."""
        with self._lock:
            self._next_ts = max(self._next_ts, ts + 1)
            self._max_assigned = max(self._max_assigned, ts)

    def bump_uid(self, uid: int) -> None:
        """Ensure future leases start above an externally-loaded uid
        (reference: bulk-load → zero lease handoff)."""
        with self._lock:
            self._next_uid = max(self._next_uid, uid + 1)

    @property
    def max_uid(self) -> int:
        """Highest uid ever leased or bumped — the watermark a rejoining
        node must hand Zero so leases never reuse uids minted in a WAL
        tail (reference: zero assign.go lease restore), and the `maxUID`
        of the HTTP front end's /state document."""
        with self._lock:
            return self._next_uid - 1

    # -- commit arbitration -------------------------------------------------
    def commit(self, start_ts: int, conflict_keys) -> int:
        """First-committer-wins commit; returns commit_ts or raises
        TxnAborted (reference: zero oracle.go `commit`)."""
        with self._lock:
            st = self._pending.get(start_ts)
            if st is None or st.commit_ts != 0:
                raise TxnAborted(f"txn {start_ts} is not pending")
            keys = {fingerprint(k) for k in conflict_keys}
            for k in keys:
                if self._commits.get(k, 0) > start_ts:
                    st.commit_ts = -1
                    raise TxnAborted(
                        f"conflict on key committed after ts {start_ts}")
            commit_ts = self._next_ts
            self._next_ts += 1
            for k in keys:
                self._commits[k] = commit_ts
            st.commit_ts = commit_ts
            self._max_assigned = max(self._max_assigned, commit_ts)
            return commit_ts

    def abort(self, start_ts: int) -> None:
        with self._lock:
            st = self._pending.get(start_ts)
            if st is not None and st.commit_ts == 0:
                st.commit_ts = -1

    def expire_older_than(self, max_age_s: float) -> int:
        """Abort pending txns OLDER than max_age_s (age since start, not
        idleness — Zero only hears from a txn again at commit). A
        coordinator that crashed without abort must not pin the gc
        watermark forever (reference: Zero lease timeouts). A later
        commit of an expired txn raises TxnAborted, exactly like a lost
        conflict; max_age_s is therefore also the ceiling on transaction
        lifetime and should be generous."""
        cutoff = time.monotonic() - max_age_s
        n = 0
        with self._lock:
            for st in self._pending.values():
                if st.commit_ts == 0 and st.created < cutoff:
                    st.commit_ts = -1
                    n += 1
        return n

    def status(self, start_ts: int) -> TxnStatus | None:
        with self._lock:
            return self._pending.get(start_ts)
