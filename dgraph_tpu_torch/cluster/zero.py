"""Zero: the standalone cluster manager service.

Port of `dgraph_tpu/cluster/zero.py`, all of it: `ZeroState` with its
journal, compaction, leases, heartbeats, replica cursor and `promote`,
`ZeroService` and `make_zero_server`, `move_tablet` and `rebalance_once`,
`elect_better` and `run_standby`, `ZeroClient` and `RemoteOracle`.
Zero holds no tensors and takes no device. Its locks are plain
`threading` locks, and its gRPC method paths are the reference's
(`dgraph_tpu.Zero`), so a port Alpha joins a reference Zero and the
reverse. The messages are the port's own (`protos/task_pb2.py`).

Reference parity: `dgraph/cmd/zero/` — group-0 authority for timestamp and
uid leases (assign.go), txn commit arbitration (oracle.go), Alpha
membership (Connect + membership stream), and tablet→group assignment
(tablet.go ShouldServe: first group to ask for an unowned predicate gets
it). The reference replicates this state machine via group-0 Raft; here it
is one process whose state is the cluster's source of truth — Alphas are
stateless against it (restart = reconnect), which matches the
reloadable-sidecar failure model (SURVEY §5).

Membership is polled (`Membership` RPC + a change counter) instead of
streamed — same information, simpler transport.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures

import grpc

from dgraph_tpu_torch.cluster.oracle import Oracle, TxnAborted
from dgraph_tpu_torch.protos import task_pb2 as pb

SERVICE_ZERO = "dgraph_tpu.Zero"


LEASE_BLOCK = 1000   # ts/uid leases persist at block granularity
# HA tuning: how far (in lease blocks) issuance may outrun the standby's
# replication ack, how long a silent standby stays attached (and gating),
# and the doc_log length that triggers compaction when nothing is tailing
MAX_UNACKED_BLOCKS = 4
STANDBY_GRACE_S = 15.0
DOC_LOG_CAP = 8192
# peer-health reports: alphas ship their breaker/latency view
# (/debug/peers) + per-tablet cost sums in a health heartbeat; reports
# older than this no longer veto a move target (a healed peer must not
# stay blacklisted by a stale report)
HEALTH_TTL_S = 60.0


class ZeroState:
    """Membership + tablets + the oracle, under one lock.

    With `journal_path` set, every state transition (join, tablet claim,
    move, removal) and lease-block boundary is fsync'd to a Journal and
    replayed on restart — Zero's tablet map and watermarks survive without
    any Alpha rejoining (reference: group-0 raft WAL + snapshots). Leases
    persist per LEASE_BLOCK: a restart skips to the end of the last
    persisted block, burning at most one block of unused ids — the same
    trade the reference's batched lease makes."""

    def __init__(self, replicas: int = 1, journal_path: str | None = None,
                 txn_timeout_s: float = 0.0, liveness_s: float = 10.0,
                 standby: bool = False):
        self.oracle = Oracle()
        self.replicas = replicas
        self.txn_timeout_s = txn_timeout_s
        self.liveness_s = liveness_s
        self._lock = threading.Lock()
        self._next_node = 1
        self._next_group = 1
        # group_id -> {node_id: addr}
        self.groups: dict[int, dict[int, str]] = {}
        # pred -> group_id
        self.tablets: dict[str, int] = {}
        # group_id -> {pred: approx bytes} (rebalance input)
        self.tablet_sizes: dict[int, dict[str, int]] = {}
        # node_id -> freshest health report (peer breaker states +
        # per-tablet cost sums; see report_health) — placement input
        self.alpha_health: dict[int, dict] = {}
        self.counter = 0
        # node_id -> monotonic last-heard time (liveness; reference: the
        # membership-stream health Zero keeps per Alpha)
        self.last_seen: dict[int, float] = {}
        # every state-machine doc in order, JSON-encoded — the standby
        # replication log (reference: the group-0 raft log followers
        # tail). _doc_base is the absolute index of doc_log[0]: a primary
        # with no attached standby compacts the prefix, and a follower
        # landing below the base bootstraps from a state snapshot doc.
        self.doc_log: list[str] = []
        self._doc_base = 0
        # (ts_block, uid_block) AFTER each doc — journal_tail derives the
        # follower's acked lease floor from these
        self._blocks_at: list[tuple[int, int]] = []
        # identity of this doc stream; a follower seeing it change knows
        # the primary restarted with a fresh log and resyncs from zero
        self.log_id = ""
        # replication ack state (primary side): highest doc index a
        # standby confirmed + the lease blocks covered by it; issuance is
        # gated so a promoted standby's floor always clears every id the
        # primary ever returned (see lease_headroom_ok)
        self._standby_acked = 0
        self._standby_seen_at = 0.0
        self._acked_ts_block = 0
        self._acked_uid_block = 0
        # standby mode: replays a primary's journal, refuses
        # lease/commit/connect RPCs until promoted
        self.standby = standby
        # after promotion: txns started under the old primary (start_ts
        # at or below this) abort — their conflict history died with it
        self.promote_floor = 0
        self._journal = None
        self._ts_block = 0
        self._uid_block = 0
        if journal_path:
            from dgraph_tpu_torch.store.wal import Journal
            for doc in Journal.replay(journal_path):
                self._replay(doc)
            self._journal = Journal(journal_path)
        if not standby and not self.log_id:
            import uuid
            self.log_id = uuid.uuid4().hex
            self._log({"k": "logid", "v": self.log_id})
        # nodes restored from the journal get a full liveness window to
        # report in before being declared dead
        import time as _time
        now = _time.monotonic()
        for nodes in self.groups.values():
            for nid in nodes:
                self.last_seen.setdefault(nid, now)

    def _replay(self, doc: dict) -> None:
        import time as _time
        k = doc["k"]
        if k == "join":
            self.groups.setdefault(doc["g"], {})[doc["n"]] = doc["a"]
            self._next_node = max(self._next_node, doc["n"] + 1)
            self._next_group = max(self._next_group, doc["g"] + 1)
            self.last_seen.setdefault(doc["n"], _time.monotonic())
        elif k == "tablet":
            self.tablets[doc["p"]] = doc["g"]
        elif k == "remove":
            for nodes in self.groups.values():
                nodes.pop(doc["n"], None)
        elif k == "tablet_del":
            self.tablets.pop(doc["p"], None)
        elif k == "ts":
            self._ts_block = max(self._ts_block, doc["v"])
            self.oracle.bump_ts(doc["v"])
        elif k == "uid":
            self._uid_block = max(self._uid_block, doc["v"])
            self.oracle.bump_uid(doc["v"])
        elif k == "promote":
            self.promote_floor = max(self.promote_floor, doc["v"])
        elif k == "logid":
            self.log_id = doc["v"]
        elif k == "snap":
            # full-state bootstrap (the primary compacted its log below
            # our cursor): replace membership/tablets wholesale; lease
            # floors only ever ratchet up
            self.groups = {int(g): {int(n): a for n, a in nodes.items()}
                           for g, nodes in doc["groups"].items()}
            self.tablets = dict(doc["tablets"])
            self._next_node = doc["nn"]
            self._next_group = doc["ng"]
            self._ts_block = max(self._ts_block, doc["tsb"])
            self._uid_block = max(self._uid_block, doc["uidb"])
            self.oracle.bump_ts(doc["tsb"])
            self.oracle.bump_uid(doc["uidb"])
            self.promote_floor = max(self.promote_floor, doc["pf"])
            now = _time.monotonic()
            for nodes in self.groups.values():
                for nid in nodes:
                    self.last_seen.setdefault(nid, now)
        self.counter += 1
        self._append_doc(doc)

    def _append_doc(self, doc: dict) -> None:
        import json as _json
        self.doc_log.append(_json.dumps(doc, separators=(",", ":")))
        self._blocks_at.append((self._ts_block, self._uid_block))

    def _log(self, doc: dict) -> None:
        self._append_doc(doc)
        if self._journal is not None:
            self._journal.append(doc)
        self._maybe_compact()

    def _snap_doc(self) -> dict:
        return {"k": "snap",
                "groups": {g: dict(n) for g, n in self.groups.items()},
                "tablets": dict(self.tablets),
                "nn": self._next_node, "ng": self._next_group,
                "tsb": self._ts_block, "uidb": self._uid_block,
                "pf": self.promote_floor}

    def _maybe_compact(self) -> None:
        """Bound doc_log memory on a primary nothing is tailing (lease
        docs accrete one per block forever). With a recently-attached
        standby the log is left alone; a follower that lands below the
        compacted base bootstraps from a snapshot doc instead."""
        import time as _time
        if len(self.doc_log) <= DOC_LOG_CAP:
            return
        if self._standby_seen_at and \
                _time.monotonic() - self._standby_seen_at < STANDBY_GRACE_S:
            return
        drop = len(self.doc_log) // 2
        self._doc_base += drop
        del self.doc_log[:drop]
        del self._blocks_at[:drop]

    def replica_cursor(self) -> tuple:
        """(applied journal seq, standby?, log identity) read under
        the lock — what every journal-tail response, election probe,
        and standby resume needs. These fields are written under the
        lock by the replay/promote/reset paths on OTHER threads; the
        race sanitizer caught the former unlocked reads (a restarted
        standby daemon racing its predecessor's epoch)."""
        with self._lock:
            return (self._doc_base + len(self.doc_log), self.standby,
                    self.log_id)

    def persist_leases(self) -> None:
        """Journal the lease watermarks at block granularity — called on
        the issuing paths, fsyncs only when a block boundary is crossed.
        Runs even without a file journal: the in-memory doc_log is what a
        STANDBY tails, and it must see lease blocks to keep its oracle
        floor current."""
        ts = self.oracle.max_assigned
        uid = self.oracle.max_uid
        with self._lock:
            if ts >= self._ts_block:
                self._ts_block = (ts // LEASE_BLOCK + 1) * LEASE_BLOCK
                self._log({"k": "ts", "v": self._ts_block})
            if uid >= self._uid_block:
                self._uid_block = (uid // LEASE_BLOCK + 1) * LEASE_BLOCK
                self._log({"k": "uid", "v": self._uid_block})

    def expire_stale_txns(self) -> int:
        """Abort pending transactions older than txn_timeout_s — a crashed
        coordinator must not pin the gc watermark forever (reference: Zero
        expires via MaxAssigned + timeouts). Returns the abort count."""
        if not self.txn_timeout_s:
            return 0
        return self.oracle.expire_older_than(self.txn_timeout_s)

    # -- liveness + standby replication (reference: membership health
    # stream + group-0 raft log shipping) --------------------------------
    def heartbeat(self, node_id: int, group: int = 0, max_ts: int = 0,
                  max_uid: int = 0) -> None:
        """Alpha liveness ping. The applied watermarks ride along so a
        freshly-promoted standby's lease space climbs past everything any
        live Alpha has actually seen."""
        import time as _time
        with self._lock:
            self.last_seen[node_id] = _time.monotonic()
        if max_ts:
            self.oracle.bump_ts(max_ts)
        if max_uid:
            self.oracle.bump_uid(max_uid)

    def dead_nodes(self) -> list[int]:
        """Known nodes not heard from within the liveness window."""
        import time as _time
        if not self.liveness_s:
            return []
        now = _time.monotonic()
        with self._lock:
            known = {nid for nodes in self.groups.values() for nid in nodes}
            return sorted(
                nid for nid in known
                if now - self.last_seen.get(nid, now) > self.liveness_s)

    def journal_tail(self, since: int) -> tuple[list[str], int]:
        """State-machine docs after absolute index `since` (follower
        pull). The call doubles as the replication ACK: everything below
        `since` provably arrived, which advances the acked lease floor
        that gates issuance (lease_headroom_ok). A cursor below the
        compacted base gets a full-state snapshot doc instead."""
        import json as _json
        import time as _time
        with self._lock:
            self._standby_seen_at = _time.monotonic()
            if since > self._standby_acked:
                self._standby_acked = since
                pos = since - self._doc_base - 1
                if 0 <= pos < len(self._blocks_at):
                    self._acked_ts_block, self._acked_uid_block = \
                        self._blocks_at[pos]
            end = self._doc_base + len(self.doc_log)
            if since < self._doc_base:
                return [_json.dumps(self._snap_doc(),
                                    separators=(",", ":"))], end
            return self.doc_log[since - self._doc_base:], end

    def lease_headroom_ok(self, n_ts: int = 1, n_uid: int = 0) -> bool:
        """Issuance gate: with a standby attached, never hand out an id
        more than MAX_UNACKED_BLOCKS lease blocks past what the standby
        has confirmed — so its promotion floor (replayed blocks + the
        same margin) always clears every id this primary ever returned.
        The WHOLE grant counts (AssignUids hands out n ids in one call:
        the last id of the grant must stay under the margin, not just
        the first). A standby dark past STANDBY_GRACE_S detaches and the
        gate lifts (availability over safety, as any 2-node HA must
        choose)."""
        import time as _time
        with self._lock:
            if not self._standby_seen_at or _time.monotonic() - \
                    self._standby_seen_at > STANDBY_GRACE_S:
                return True
            margin = MAX_UNACKED_BLOCKS * LEASE_BLOCK
            return (self.oracle.max_assigned + n_ts
                    <= self._acked_ts_block + margin
                    and self.oracle.max_uid + n_uid
                    <= self._acked_uid_block + margin)

    def apply_remote(self, docs_json: list[str]) -> None:
        """Standby: replay docs pulled from the primary, persisting them
        to our own journal so a standby restart (or chained standby)
        keeps the full log."""
        import json as _json
        for dj in docs_json:
            doc = _json.loads(dj)
            with self._lock:
                # _replay appends to doc_log; mirror into our file journal
                self._replay(doc)
            if self._journal is not None:
                self._journal.append(doc)

    def reset_replica(self) -> None:
        """Standby resync-from-scratch (the primary's log identity
        changed): drop replicated membership state and our journal, keep
        the oracle floors and promote_floor — those only ratchet up and
        guard ts/uid uniqueness across regimes."""
        with self._lock:
            self.groups.clear()
            self.tablets.clear()
            self.tablet_sizes.clear()
            self.doc_log.clear()
            self._blocks_at.clear()
            self._doc_base = 0
            self.counter = 0
            self.log_id = ""
            self._next_node = 1
            self._next_group = 1
            if self._journal is not None:
                self._journal.rewrite([])

    def promote(self) -> None:
        """Standby → primary. The primary's issuance gate guarantees it
        never returned an id more than MAX_UNACKED_BLOCKS blocks past our
        last acked pull, so replayed blocks + that margin + 1 clears
        everything it ever handed out; the promote floor then aborts
        txns whose conflict history died with the old process."""
        from dgraph_tpu_torch.utils.metrics import METRICS
        METRICS.inc("election_promoted_total")
        margin = (MAX_UNACKED_BLOCKS + 1) * LEASE_BLOCK
        # read the replayed lease blocks under the lock (a straggling
        # apply_remote pull may still be advancing them); the oracle
        # bumps stay outside — the oracle has its own lock
        with self._lock:
            ts_block, uid_block = self._ts_block, self._uid_block
        floor = max(self.oracle.max_assigned, ts_block)
        self.oracle.bump_ts((floor // LEASE_BLOCK) * LEASE_BLOCK + margin)
        self.oracle.bump_uid(
            (max(self.oracle.max_uid, uid_block) // LEASE_BLOCK)
            * LEASE_BLOCK + margin)
        import time as _time
        now = _time.monotonic()
        with self._lock:
            self.promote_floor = max(self.promote_floor,
                                     self.oracle.max_assigned)
            self._log({"k": "promote", "v": self.promote_floor})
            self.counter += 1
            self.standby = False
            # the failover window ate everyone's heartbeats: restart the
            # liveness clocks rather than declaring the fleet dead
            for nodes in self.groups.values():
                for nid in nodes:
                    self.last_seen[nid] = now
        self.persist_leases()

    def report_sizes(self, group: int, sizes: dict[str, int]) -> None:
        with self._lock:
            self.tablet_sizes[group] = dict(sizes)

    # -- peer health + tablet cost reports (placement input) -----
    def report_health(self, doc: dict) -> None:
        """One alpha's health heartbeat: its breaker/latency view of
        every peer it dials (cluster/resilience.py snapshot) plus the
        per-tablet cost sums it measured (utils/costprofile.py). Zero
        keeps the freshest report per node; move/rebalance decisions
        read the aggregate (peer_unhealthy / group_cost_load)."""
        import time as _time
        node_id = int(doc.get("node_id", 0))
        with self._lock:
            self.alpha_health[node_id] = {
                "at": _time.monotonic(),
                "group": int(doc.get("group", 0)),
                "addr": str(doc.get("addr", "")),
                "peers": dict(doc.get("peers", {})),
                "tablet_costs": {str(p): int(c) for p, c in
                                 dict(doc.get("tablet_costs",
                                              {})).items()},
            }

    def unhealthy_addrs(self) -> set[str]:
        """Addresses NO tablet move should target right now: any peer a
        FRESH health report marks breaker open/half-open (some alpha is
        actively failing to reach it), plus every liveness-dead node's
        address. Stale reports (past HEALTH_TTL_S) don't veto — a
        healed peer must come back into rotation."""
        import time as _time
        now = _time.monotonic()
        dead = set(self.dead_nodes())
        with self._lock:
            bad: set[str] = set()
            for nodes in self.groups.values():
                for nid, addr in nodes.items():
                    if nid in dead:
                        bad.add(addr)
            for rep in self.alpha_health.values():
                if now - rep["at"] > HEALTH_TTL_S:
                    continue
                for addr, p in rep["peers"].items():
                    if p.get("state") in ("open", "half_open"):
                        bad.add(addr)
            return bad

    def group_cost_load(self, group: int) -> int:
        """Measured µs-equivalents of tablet work the group's nodes
        reported (freshest report per node) — the load half of the
        placement decision the byte sizes alone can't see (a small, hot
        tablet)."""
        import time as _time
        now = _time.monotonic()
        with self._lock:
            total = 0
            for rep in self.alpha_health.values():
                if rep["group"] != group \
                        or now - rep["at"] > HEALTH_TTL_S:
                    continue
                total += sum(rep["tablet_costs"].values())
            return total

    def move_tablet(self, pred: str, dst_group: int) -> bool:
        """Flip a tablet's owner (the map half of a move; the data ship
        happens first — see ZeroService.MoveTablet / rebalance_once)."""
        with self._lock:
            if dst_group not in self.groups or \
                    self.tablets.get(pred) == dst_group:
                return False
            self.tablets[pred] = dst_group
            self._log({"k": "tablet", "p": pred, "g": dst_group})
            self.counter += 1
            return True

    def rebalance_candidate(self):
        """Pick (pred, src_group, dst_group): move the smallest tablet
        of the most-loaded group to the least-loaded HEALTHY group, if
        the imbalance is worth it (reference: zero/tablet.go rebalance
        loop). Load is the reported byte size PLUS the reported tablet
        cost sums (µs-equivalents — a small but hot tablet weighs in),
        and a group none of whose nodes are currently healthy is never
        a destination (`zero_moves_skipped_unhealthy_total`)."""
        from dgraph_tpu_torch.utils.metrics import METRICS
        bad = self.unhealthy_addrs()           # takes the lock itself
        # snapshot the group ids under the lock; group_cost_load takes
        # the (non-reentrant) lock itself, so it cannot run inside it
        with self._lock:
            gids = list(self.groups)
        cost = {g: self.group_cost_load(g) for g in gids}
        with self._lock:
            if len(self.groups) < 2:
                return None
            load = {g: sum(self.tablet_sizes.get(g, {}).values())
                    + cost.get(g, 0)
                    for g in self.groups}
            src = max(load, key=load.get)
            ranked = [g for g in sorted(load, key=load.get) if g != src]
            healthy_dst = [g for g in ranked
                           if any(a not in bad
                                  for a in self.groups[g].values())]
            if not healthy_dst:
                # every candidate destination is unhealthy: no move
                METRICS.inc("zero_moves_skipped_unhealthy_total")
                return None
            dst = healthy_dst[0]
            if dst != ranked[0]:
                # the least-loaded group was vetoed by peer health
                METRICS.inc("zero_moves_skipped_unhealthy_total")
            if load[src] <= 1.5 * max(load[dst], 1):
                return None
            movable = {p: s for p, s in self.tablet_sizes[src].items()
                       if self.tablets.get(p) == src}
            if not movable:
                return None
            pred = min(movable, key=movable.get)
            return pred, src, dst

    def connect(self, addr: str, group: int = 0, max_ts: int = 0,
                max_uid: int = 0) -> tuple[int, int]:
        """Join the cluster (reference: zero.Server.Connect). With group=0
        Zero fills existing groups up to `replicas` before opening a new
        one — the --replicas elasticity model. The joiner's persisted
        watermarks bump the lease space: a node with replayed history must
        never see Zero hand out timestamps or uids below what it already
        holds (reference: Zero restores these from its raft snapshot; this
        Zero is memory-only, so joiners carry them)."""
        self.oracle.bump_ts(max_ts)
        if max_uid:
            self.oracle.bump_uid(max_uid)
        # the bumped watermarks must hit the journal NOW: a crash before
        # the next lease-issuing RPC would otherwise replay lower blocks
        # and re-lease ids the joiner's store already holds
        self.persist_leases()
        import time as _time
        with self._lock:
            # a rejoining node reclaims its recorded identity by address —
            # a journal-replayed membership must not trap a restarted
            # cluster's tablets in ghost groups (reference: raft id reuse
            # on rejoin)
            for g, nodes in self.groups.items():
                for nid, a in nodes.items():
                    if a == addr and (not group or group == g):
                        self.last_seen[nid] = _time.monotonic()
                        return nid, g
            node_id = self._next_node
            self._next_node += 1
            gid = group
            if not gid:
                for g, nodes in sorted(self.groups.items()):
                    if len(nodes) < self.replicas:
                        gid = g
                        break
                else:
                    gid = self._next_group
            self.groups.setdefault(gid, {})[node_id] = addr
            self._next_group = max(self._next_group, gid + 1)
            self.last_seen[node_id] = _time.monotonic()
            self._log({"k": "join", "n": node_id, "g": gid, "a": addr})
            self.counter += 1
            return node_id, gid

    def remove_node(self, node_id: int) -> None:
        """Operator removal (reference: /removeNode)."""
        with self._lock:
            for nodes in self.groups.values():
                nodes.pop(node_id, None)
            self._log({"k": "remove", "n": node_id})
            self.counter += 1

    def remove_tablet(self, pred: str) -> None:
        """Drop a predicate's tablet assignment (reference: DropAttr
        deletes the tablet from Zero's map)."""
        with self._lock:
            if pred in self.tablets:
                del self.tablets[pred]
                for sizes in self.tablet_sizes.values():
                    sizes.pop(pred, None)
                self._log({"k": "tablet_del", "p": pred})
                self.counter += 1

    def should_serve(self, pred: str, group: int) -> int:
        """Tablet assignment: first group to ask for an unowned predicate
        gets it (reference: zero/tablet.go ShouldServe)."""
        with self._lock:
            owner = self.tablets.get(pred)
            if owner is None:
                self.tablets[pred] = owner = group
                self._log({"k": "tablet", "p": pred, "g": group})
                self.counter += 1
            return owner

    def membership(self) -> pb.MembershipState:
        dead = self.dead_nodes()
        with self._lock:
            st = pb.MembershipState(counter=self.counter)
            st.dead.extend(dead)
            for gid, nodes in self.groups.items():
                g = pb.Group()
                for nid, addr in nodes.items():
                    g.nodes[nid] = addr
                g.tablets.extend(
                    sorted(p for p, og in self.tablets.items() if og == gid))
                st.groups[gid].CopyFrom(g)
            return st


class ZeroService:
    def __init__(self, state: ZeroState):
        self.state = state

    def _primary_only(self, ctx) -> None:
        """Lease/commit/membership-mutating RPCs are refused while in
        standby — a client holding both addresses must not split-brain
        the lease space (reference: only the group-0 raft leader
        serves)."""
        if self.state.replica_cursor()[1]:
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                      "zero is a standby (not promoted)")

    def _lease_gate(self, ctx, n_ts: int = 1, n_uid: int = 0) -> None:
        """Refuse id issuance that would outrun the attached standby's
        replication ack — the invariant a safe promotion floor rests on."""
        if n_ts + n_uid >= MAX_UNACKED_BLOCKS * LEASE_BLOCK:
            ctx.abort(grpc.StatusCode.INVALID_ARGUMENT,
                      "grant larger than the replication margin")
        if not self.state.lease_headroom_ok(n_ts, n_uid):
            # RESOURCE_EXHAUSTED (not UNAVAILABLE): a deliberate answer
            # for THIS caller — connectivity-style codes would invite
            # client-side failover to the standby, which can only refuse
            ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                      "lease space awaiting standby replication; retry")

    def Connect(self, req: pb.ConnectRequest, ctx) -> pb.ConnectResponse:
        self._primary_only(ctx)
        nid, gid = self.state.connect(req.addr, int(req.group),
                                      int(req.max_ts), int(req.max_uid))
        return pb.ConnectResponse(node_id=nid, group_id=gid)

    def Membership(self, req: pb.Empty, ctx) -> pb.MembershipState:
        return self.state.membership()

    def ShouldServe(self, req: pb.TabletRequest, ctx) -> pb.Tablet:
        self._primary_only(ctx)
        owner = self.state.should_serve(req.pred, int(req.group))
        return pb.Tablet(pred=req.pred, group=owner)

    def Timestamps(self, req: pb.TsRequest, ctx) -> pb.AssignedIds:
        self._primary_only(ctx)
        self._lease_gate(ctx)
        o = self.state.oracle
        ts = o.read_only_ts() if req.read_only else o.read_ts()
        self.state.persist_leases()
        return pb.AssignedIds(start_id=ts, end_id=ts)

    def AssignUids(self, req: pb.AssignRequest, ctx) -> pb.AssignedIds:
        self._primary_only(ctx)
        self._lease_gate(ctx, n_ts=0, n_uid=int(req.num))
        r = self.state.oracle.assign_uids(int(req.num))
        self.state.persist_leases()
        return pb.AssignedIds(start_id=r.start, end_id=r.stop - 1)

    def Heartbeat(self, req: pb.HeartbeatMsg, ctx) -> pb.Payload:
        # standbys accept heartbeats too: the watermarks seed their lease
        # floor for promotion
        self.state.heartbeat(int(req.node_id), int(req.group),
                             int(req.max_ts), int(req.max_uid))
        return pb.Payload(data=b"ok")

    def JournalTail(self, req: pb.JournalTailRequest, ctx) -> pb.JournalDocs:
        if req.peek:
            # election probe: report applied seq WITHOUT the replication
            # ACK side effect (journal_tail treats `since` as an ack and
            # would pin the lease floor / freshen standby liveness)
            nxt, standby, log_id = self.state.replica_cursor()
            return pb.JournalDocs(docs_json=[], next=nxt,
                                  standby=standby, log_id=log_id)
        docs, nxt = self.state.journal_tail(int(req.since))
        _seq, standby, log_id = self.state.replica_cursor()
        return pb.JournalDocs(docs_json=docs, next=nxt,
                              standby=standby, log_id=log_id)

    def ReportTablets(self, req: pb.TabletSizes, ctx) -> pb.Payload:
        self.state.report_sizes(int(req.group), dict(req.sizes))
        return pb.Payload(data=b"ok")

    def ReportHealth(self, req: pb.Payload, ctx) -> pb.Payload:
        """Alpha health heartbeat: a JSON doc in Payload.data
        — {node_id, group, addr, peers: {addr: {state, ema_latency_us}},
        tablet_costs: {pred: µs}} — no proto change needed (Payload is
        the existing opaque envelope). Malformed docs are dropped, never
        a crashed heartbeat loop. Re-establishes the caller's trace
        context from metadata (server/task._inbound_trace) so a traced
        report shows up as ONE cross-process trace."""
        import json as _json

        from dgraph_tpu_torch.server.task import _inbound_trace
        with _inbound_trace(ctx):
            try:
                doc = _json.loads(req.data.decode() or "{}")
            except (UnicodeDecodeError, ValueError):
                return pb.Payload(data=b"bad")
            self.state.report_health(doc)
            return pb.Payload(data=b"ok")

    def RemoveTablet(self, req: pb.TabletRequest, ctx) -> pb.Payload:
        self._primary_only(ctx)
        self.state.remove_tablet(req.pred)
        return pb.Payload(data=b"ok")

    def MoveTablet(self, req: pb.MoveTabletRequest, ctx) -> pb.Payload:
        ok = move_tablet(self.state, req.pred, int(req.dst_group))
        return pb.Payload(data=b"ok" if ok else b"noop")

    def Commit(self, req: pb.CommitRequest, ctx) -> pb.TxnContext:
        self._primary_only(ctx)
        if req.abort:
            self.state.oracle.abort(int(req.start_ts))
            return pb.TxnContext(start_ts=req.start_ts, aborted=True)
        self._lease_gate(ctx)
        with self.state._lock:
            promote_floor = self.state.promote_floor
        if promote_floor and int(req.start_ts) <= promote_floor:
            # the txn began under the dead primary: its conflict history
            # (and any concurrent committers it raced) died with that
            # process — abort rather than risk a lost-update
            ctx.abort(grpc.StatusCode.ABORTED,
                      "txn predates zero failover; retry")
        try:
            cts = self.state.oracle.commit(int(req.start_ts),
                                           list(req.keys))
        except TxnAborted as e:
            ctx.abort(grpc.StatusCode.ABORTED, str(e))
        self.state.persist_leases()
        return pb.TxnContext(start_ts=req.start_ts, commit_ts=cts)


def move_tablet(state: ZeroState, pred: str, dst_group: int) -> bool:
    """Orchestrate a tablet move (reference: zero/tablet.go
    movePredicate): ship a snapshot to EVERY destination replica, flip
    the map once, then ship the copy-window delta to each. Queries keep
    answering throughout — before the flip the old group serves; after
    it, the new owners (already loaded) do. The flip only happens after
    at least one replica holds the bulk copy; delta failures retry and
    are loudly logged (the replica heals fully on its next rejoin
    resync).

    Peer health gates the TARGETS: a destination replica that
    any fresh alpha health report marks breaker-open/half-open — or
    that liveness declares dead — is never pulled to; with EVERY
    destination replica unhealthy the move is refused outright
    (`zero_moves_skipped_unhealthy_total`). Shipping a tablet onto a
    half-dead node would hand its reads to the one peer the fleet
    already can't reach."""
    import contextlib
    import time as _time

    from dgraph_tpu_torch.server.task import Client
    from dgraph_tpu_torch.utils import logging as xlog
    from dgraph_tpu_torch.utils.metrics import METRICS
    log = xlog.get("zero")
    bad = state.unhealthy_addrs()
    with state._lock:
        src_group = state.tablets.get(pred)
        src_nodes = dict(state.groups.get(src_group, {}))
        dst_nodes = dict(state.groups.get(dst_group, {}))
    if src_group is None or src_group == dst_group or not dst_nodes \
            or not src_nodes:
        return False
    healthy_dst = {n: a for n, a in dst_nodes.items() if a not in bad}
    if not healthy_dst:
        METRICS.inc("zero_moves_skipped_unhealthy_total")
        log.warning(
            "move of %s to group %d refused: every destination replica "
            "%s is breaker-open or dead per peer health reports",
            pred, dst_group, sorted(dst_nodes.values()))
        return False
    if len(healthy_dst) < len(dst_nodes):
        log.info("move of %s: skipping unhealthy replica(s) %s",
                 pred, sorted(set(dst_nodes.values())
                              - set(healthy_dst.values())))
    dst_nodes = healthy_dst
    src_addr = sorted(src_nodes.values())[0]
    with contextlib.ExitStack() as stack:
        clients = []
        for addr in sorted(dst_nodes.values()):
            c = Client(addr)
            stack.callback(c.close)
            clients.append((addr, c))
        loaded = []
        for addr, c in clients:                # bulk copy, map unflipped
            try:
                c.pull_tablet(pred, src_addr)
                loaded.append((addr, c))
            except grpc.RpcError as e:
                log.warning("bulk pull of %s to %s failed: %s",
                            pred, addr, e)
        if not loaded:
            return False
        if not state.move_tablet(pred, dst_group):
            return False
        # zero-side tablet move — no
        # request budget; pull_tablet is idempotent (full-state copy)
        for addr, c in loaded:                 # copy-window delta
            # see outer loop
            for attempt in range(3):
                try:
                    c.pull_tablet(pred, src_addr)
                    break
                except grpc.RpcError as e:
                    if attempt == 2:
                        log.error(
                            "delta pull of %s to %s failed after flip "
                            "(%s); replica misses copy-window writes "
                            "until it resyncs", pred, addr, e)
                    else:
                        _time.sleep(0.2)
    return True


def rebalance_once(state: ZeroState) -> bool:
    """One sweep of the size-based rebalance loop (reference:
    zero/tablet.go runRebalance)."""
    cand = state.rebalance_candidate()
    if cand is None:
        return False
    pred, _src, dst = cand
    return move_tablet(state, pred, dst)


# election outcome when require_quorum is set and too few standbys are
# reachable: the caller must NOT promote (consistency over availability)
NO_QUORUM = object()


def elect_better(state: ZeroState, my_addr: str, peers,
                 require_quorum: bool = False):
    """Highest-acked-index election among standbys (reference: raft's
    up-to-date-log vote rule, collapsed to a deterministic comparison):
    returns the address of a peer strictly ahead of this standby under
    (applied journal seq, addr) ordering — that peer should promote
    instead — None when THIS standby wins, or NO_QUORUM. A reachable
    peer that already promoted wins outright.

    With require_quorum=False (availability mode): unreachable peers
    don't vote — a standby cut off from every other standby still
    promotes, trading raft's vote quorum for availability;
    log-identity divergence stays operator-visible via log_id. With
    require_quorum=True (the DEFAULT whenever run_standby has peers
    configured) the raft trade is made instead: promotion needs a
    MAJORITY of the standby electorate (self + peers) reachable, so
    standbys partitioned from each other defer (NO_QUORUM) rather
    than dual-promote.

    Mixed-version `peek` hazard: the probe uses JournalTail(peek=true).
    A peer running a build that predates the peek field ignores it and
    serves journal_tail(0) WITH its side effects — the call refreshes
    `_standby_seen_at`, so a probed PRIMARY would believe a standby is
    attached and gate its lease issuance (lease_headroom_ok) until
    STANDBY_GRACE_S lapses. since=0 never regresses the acked floor
    (the ack only ratchets up), so safety holds — the cost is spurious
    RESOURCE_EXHAUSTED retries during a mixed-version rollout."""
    from dgraph_tpu_torch.utils.metrics import METRICS
    my_seq = state.replica_cursor()[0]
    best = None
    reachable = 1                     # self
    for addr in peers:
        try:
            docs_, nxt, standby, _lid = ZeroClient(addr).journal_tail_full(
                0, peek=True)
        except grpc.RpcError:
            METRICS.inc("election_peer_unreachable_total")
            continue
        reachable += 1
        if not standby:
            return addr               # someone already took over
        if (nxt, addr) > (my_seq, my_addr) and \
                (best is None or (nxt, addr) > best):
            best = (nxt, addr)
    if best:
        METRICS.inc("election_lost_total")
        return best[1]
    if require_quorum and reachable < (len(peers) + 1) // 2 + 1:
        METRICS.inc("election_deferred_total")
        return NO_QUORUM
    return None


def run_standby(state: ZeroState, primary_addr: str, poll_s: float = 1.0,
                promote_after_s: float = 5.0, stop_event=None,
                peers=(), my_addr: str = "",
                require_quorum: bool | None = None) -> bool:
    """Standby loop: tail the primary's state-machine journal into
    `state`; when the primary stays unreachable past `promote_after_s`,
    run the highest-acked-index election over `peers` (other standby
    addresses) — the most caught-up standby promotes, the rest re-target
    it (reference: group-0 raft follower election; with no peers this
    collapses to the designated-successor behavior). Returns True when
    promoted, False when stopped externally.

    require_quorum=None (default) resolves to SAFE-BY-DEFAULT: with an
    electorate configured (peers non-empty), promotion requires a
    majority of it reachable — a symmetric standby partition defers
    instead of dual-promoting (raft's consistency choice). Availability
    mode (require_quorum=False with peers) is an explicit opt-out and
    logs loudly. A standby with NO peers keeps the designated-successor
    behavior — there is no electorate to consult.

    A restarted standby resumes from its own replayed log length; a
    log-identity change (the primary restarted with a fresh log) resets
    the replica and resyncs from zero."""
    import time as _time
    if require_quorum is None:
        require_quorum = bool(peers)
    elif peers and not require_quorum:
        from dgraph_tpu_torch.utils import logging as xlog
        from dgraph_tpu_torch.utils.metrics import METRICS
        METRICS.set_gauge("election_availability_mode", 1.0)
        xlog.get("zero").warning(
            "election AVAILABILITY mode (quorum opt-out): a symmetric "
            "partition between standbys can DUAL-PROMOTE — two primaries "
            "issuing from divergent lease spaces (split-brain). Quorum "
            "elections are the default; this opt-out trades that safety "
            "for promotion while the electorate is unreachable.")
    client = ZeroClient(primary_addr)
    since, _standby_now, my_log_id = state.replica_cursor()
    expect_id = my_log_id or None
    last_ok = _time.monotonic()
    apply_fails = 0  # consecutive replica-apply failures (backoff)
    # daemon tail
    # loop — no request budget exists here; lifecycle is stop_event, and
    # an RpcError drives the ELECTION path, never a blind re-spend
    while stop_event is None or not stop_event.is_set():
        try:
            docs, nxt, _standby, log_id = client.journal_tail_full(since)
            if (expect_id is not None and log_id and log_id != expect_id) \
                    or nxt < since:
                state.reset_replica()
                since = 0
                expect_id = log_id or None
                continue
            if log_id and expect_id is None:
                expect_id = log_id
            if docs:
                state.apply_remote(docs)
            since = nxt
            last_ok = _time.monotonic()
        except grpc.RpcError:
            if _time.monotonic() - last_ok > promote_after_s:
                winner = elect_better(state, my_addr, peers,
                                      require_quorum=require_quorum)
                if winner is NO_QUORUM:
                    # too few standbys reachable to vote safely: defer
                    # and retry next poll (raft's consistency choice)
                    from dgraph_tpu_torch.utils import logging as xlog
                    xlog.get("zero").warning(
                        "election deferred: standby quorum unreachable")
                elif winner is None:
                    state.promote()
                    return True
                else:
                    # a more caught-up standby exists: it promotes, this
                    # one keeps tailing FROM it (same journal lineage,
                    # log_id unchanged through promotion)
                    primary_addr = winner
                    client = ZeroClient(winner)
                    since = state._doc_base + len(state.doc_log)
                    last_ok = _time.monotonic()
        except Exception:  # noqa: BLE001 — a malformed doc must not kill
            # the standby thread silently (failover would be lost with no
            # log line); resync the replica from zero and keep tailing.
            # A deterministically-bad doc would otherwise re-download the
            # whole journal every poll — back off exponentially and log
            # loudly only on the first consecutive failure.
            from dgraph_tpu_torch.utils import logging as xlog
            if apply_fails == 0:
                xlog.get("zero").error(
                    "standby apply failed; resetting replica",
                    exc_info=True)
            else:
                xlog.get("zero").debug(
                    "standby apply still failing (attempt %d)",
                    apply_fails + 1, exc_info=True)
            state.reset_replica()
            since = 0
            expect_id = None
            _time.sleep(min(poll_s * (2 ** apply_fails), 30.0))
            apply_fails += 1
            continue
        apply_fails = 0
        _time.sleep(poll_s)
    return False


def _unary(fn, req_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=lambda m: m.SerializeToString())


def make_zero_server(state: ZeroState | None = None,
                     addr: str = "127.0.0.1:0", max_workers: int = 8):
    """Build (grpc server, bound port, state)."""
    state = state or ZeroState()
    svc = ZeroService(state)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(SERVICE_ZERO, {
            "Connect": _unary(svc.Connect, pb.ConnectRequest),
            "Membership": _unary(svc.Membership, pb.Empty),
            "ShouldServe": _unary(svc.ShouldServe, pb.TabletRequest),
            "Timestamps": _unary(svc.Timestamps, pb.TsRequest),
            "AssignUids": _unary(svc.AssignUids, pb.AssignRequest),
            "Commit": _unary(svc.Commit, pb.CommitRequest),
            "ReportTablets": _unary(svc.ReportTablets, pb.TabletSizes),
            "ReportHealth": _unary(svc.ReportHealth, pb.Payload),
            "MoveTablet": _unary(svc.MoveTablet, pb.MoveTabletRequest),
            "RemoveTablet": _unary(svc.RemoveTablet, pb.TabletRequest),
            "Heartbeat": _unary(svc.Heartbeat, pb.HeartbeatMsg),
            "JournalTail": _unary(svc.JournalTail, pb.JournalTailRequest),
        }),))
    port = server.add_insecure_port(addr)
    return server, port, state


class ZeroClient:
    """Client to a Zero service (reference: the zero conn every Alpha
    holds). `target` may be a comma-separated failover list
    ("primary:5080,standby:5081"): connectivity errors and standby
    refusals rotate to the next address; semantic errors (txn aborts)
    propagate.

    Dead-target marking reuses the cluster breaker signals
    (cluster/resilience.py): each zero target carries per-peer breaker
    state, and the rotation starts at targets whose breaker is NOT
    open — an alpha stops paying the full dial timeout to a dead
    primary on every lease call once the breaker has seen it down.
    Every target is still tried when all breakers are open (leases
    must never be refused outright on client-side suspicion alone)."""

    def __init__(self, target: str):
        from dgraph_tpu_torch.cluster.resilience import PeerTable
        self.targets = [t.strip() for t in target.split(",") if t.strip()]
        self._chans: dict[str, grpc.Channel] = {}
        self._cur = 0
        # retries=0: the target LIST is the retry policy here — the
        # breaker only orders/skips known-dead zeros during cool-down
        self.health = PeerTable(threshold=2, cooldown_ms=1000.0,
                                retries=0)

    @property
    def channel(self) -> grpc.Channel:
        t = self.targets[self._cur]
        ch = self._chans.get(t)
        if ch is None:
            # ZeroClient pools its own
            # channels — target rotation + PeerTable IS the resilience
            # layer for zero legs (leases must try every target)
            ch = self._chans[t] = grpc.insecure_channel(t)
        return ch

    def _call(self, method: str, req, resp_cls):
        last_err = None
        # ambient trace context rides zero legs too (the task.Client
        # pattern): a traced request whose leg reaches Zero — or a
        # traced health report — stays one cross-process trace
        from dgraph_tpu_torch.utils import tracing as _tracing
        kw = {}
        tid = _tracing.current_trace_id()
        if tid and _tracing.enabled():
            kw["metadata"] = (("x-dgraph-trace-id", tid),
                              ("x-dgraph-parent-span",
                               str(_tracing.current_span_id())))
        # rotation order: current-first, but known-dead targets
        # (breaker open inside cool-down) sink to the back
        order = [(self._cur + i) % len(self.targets)
                 for i in range(len(self.targets))]
        if len(self.targets) > 1:
            order = ([i for i in order
                      if self.health.available(self.targets[i])]
                     + [i for i in order
                        if not self.health.available(self.targets[i])])
        for idx in order:
            self._cur = idx
            target = self.targets[idx]
            rpc = self.channel.unary_unary(
                f"/{SERVICE_ZERO}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)
            t0 = time.monotonic()
            try:
                out = rpc(req, **kw)
            except grpc.RpcError as e:
                code = e.code()
                if code == grpc.StatusCode.UNAVAILABLE:
                    # connectivity: breaker signal for dead-marking
                    self.health.on_failure(target, e)
                else:
                    self.health.on_success(target, None)
                if (code == grpc.StatusCode.ABORTED
                        or code == grpc.StatusCode.INVALID_ARGUMENT
                        or code == grpc.StatusCode.RESOURCE_EXHAUSTED
                        or len(self.targets) == 1):
                    # semantic errors (txn abort, oversized grant, the
                    # primary's lease gate asking THIS caller to retry)
                    # must reach the caller — rotating to the standby
                    # would mask them behind its FAILED_PRECONDITION
                    raise
                # connectivity / standby refusal: try the next zero
                last_err = e
                continue
            self.health.on_success(target, time.monotonic() - t0)
            return out
        raise last_err

    def connect(self, addr: str, group: int = 0, max_ts: int = 0,
                max_uid: int = 0) -> tuple[int, int]:
        r = self._call("Connect", pb.ConnectRequest(
            addr=addr, group=group, max_ts=max_ts, max_uid=max_uid),
            pb.ConnectResponse)
        return int(r.node_id), int(r.group_id)

    def membership(self) -> pb.MembershipState:
        return self._call("Membership", pb.Empty(), pb.MembershipState)

    def should_serve(self, pred: str, group: int) -> int:
        r = self._call("ShouldServe",
                       pb.TabletRequest(pred=pred, group=group), pb.Tablet)
        return int(r.group)

    def read_ts(self) -> int:
        r = self._call("Timestamps", pb.TsRequest(num=1), pb.AssignedIds)
        return int(r.start_id)

    def read_only_ts(self) -> int:
        r = self._call("Timestamps", pb.TsRequest(num=1, read_only=True),
                       pb.AssignedIds)
        return int(r.start_id)

    def assign_uids(self, n: int) -> range:
        r = self._call("AssignUids", pb.AssignRequest(num=n),
                       pb.AssignedIds)
        return range(int(r.start_id), int(r.end_id) + 1)

    def commit(self, start_ts: int, keys) -> int:
        try:
            r = self._call("Commit", pb.CommitRequest(
                start_ts=start_ts, keys=sorted(keys)), pb.TxnContext)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.ABORTED:
                raise TxnAborted(e.details()) from None
            raise
        return int(r.commit_ts)

    def abort(self, start_ts: int) -> None:
        self._call("Commit", pb.CommitRequest(start_ts=start_ts, abort=True),
                   pb.TxnContext)

    def report_tablets(self, group: int, sizes: dict[str, int]) -> None:
        self._call("ReportTablets",
                   pb.TabletSizes(group=group, sizes=sizes), pb.Payload)

    def report_health(self, doc: dict) -> None:
        """Ship one health heartbeat doc (see ZeroService.ReportHealth);
        the JSON rides the existing Payload envelope."""
        import json as _json
        self._call("ReportHealth", pb.Payload(
            data=_json.dumps(doc, separators=(",", ":")).encode()),
            pb.Payload)

    def heartbeat(self, node_id: int, group: int = 0, max_ts: int = 0,
                  max_uid: int = 0) -> None:
        self._call("Heartbeat", pb.HeartbeatMsg(
            node_id=node_id, group=group, max_ts=max_ts, max_uid=max_uid),
            pb.Payload)

    def journal_tail(self, since: int) -> tuple[list[str], int, bool]:
        docs, nxt, standby, _ = self.journal_tail_full(since)
        return docs, nxt, standby

    def journal_tail_full(self, since: int, peek: bool = False) \
            -> tuple[list[str], int, bool, str]:
        r = self._call("JournalTail",
                       pb.JournalTailRequest(since=since, peek=peek),
                       pb.JournalDocs)
        return (list(r.docs_json), int(r.next), bool(r.standby),
                str(r.log_id))

    def remove_tablet(self, pred: str) -> None:
        self._call("RemoveTablet", pb.TabletRequest(pred=pred),
                   pb.Payload)

    def move_tablet(self, pred: str, dst_group: int) -> bool:
        r = self._call("MoveTablet", pb.MoveTabletRequest(
            pred=pred, dst_group=dst_group), pb.Payload)
        return r.data == b"ok"

    def close(self):
        for ch in self._chans.values():
            ch.close()
        self._chans.clear()


class RemoteOracle:
    """Oracle facade backed by a Zero service — what an Alpha's txn path
    talks to in cluster mode (reference: Alphas never arbitrate commits
    themselves; Zero's oracle does). Local bookkeeping only tracks which
    timestamps THIS node handed out, for its own gc watermark."""

    def __init__(self, zero: ZeroClient):
        self.zero = zero
        self._lock = threading.Lock()
        self._local_pending: set[int] = set()
        self._max_seen = 0

    def read_ts(self) -> int:
        ts = self.zero.read_ts()
        with self._lock:
            self._local_pending.add(ts)
            self._max_seen = max(self._max_seen, ts)
        return ts

    def read_only_ts(self) -> int:
        ts = self.zero.read_only_ts()
        with self._lock:
            self._max_seen = max(self._max_seen, ts)
        return ts

    def assign_uids(self, n: int) -> range:
        return self.zero.assign_uids(n)

    def commit(self, start_ts: int, conflict_keys) -> int:
        cts = self.zero.commit(start_ts, list(conflict_keys))
        with self._lock:
            self._local_pending.discard(start_ts)
            self._max_seen = max(self._max_seen, cts)
        return cts

    def abort(self, start_ts: int) -> None:
        with self._lock:
            self._local_pending.discard(start_ts)
        self.zero.abort(start_ts)

    def min_active_ts(self) -> int:
        with self._lock:
            return (min(self._local_pending) if self._local_pending
                    else self._max_seen + 1)

    def gc(self) -> int:
        return self.min_active_ts()

    @property
    def max_assigned(self) -> int:
        with self._lock:
            return self._max_seen

    def bump_ts(self, ts: int) -> None:
        with self._lock:
            self._max_seen = max(self._max_seen, ts)

    def bump_uid(self, uid: int) -> None:
        pass  # Zero owns the uid lease space
