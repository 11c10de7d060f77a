"""Message-level fault injection for cluster tests.

Port of `dgraph_tpu/cluster/fault.py`, the testing module of the
reference package (`test_partition_fuzz.py` and `test_quorum.py` drive
it), ported as one.

Reference parity: the reference has no in-repo fault-injection framework
(Jepsen is external — SURVEY §5); deterministic partition tests need one
here. `FaultyGroups` wraps a node's `Groups` so individual DIRECTED links
(this node → peer) can be dropped or delayed — asymmetric partitions
(A hears B while B cannot reach A) become one-line test setup, which
server stops can never simulate.

Injection point: the pooled client's `fault_check` hook — it fires
before EVERY wire attempt of every outbound RPC of the wrapped node
(broadcasts, decisions, FetchLog catch-up, ServeTask routing, read
failover), INSIDE the resilience layer's retry loop
(cluster/resilience.py), so a blocked link fails exactly like an
unreachable peer (grpc UNAVAILABLE) — retried, breaker-counted — and a
delayed link stalls like a congested one."""

from __future__ import annotations

import time

import grpc


class LinkDown(grpc.RpcError):
    """UNAVAILABLE-shaped error for a dropped directed link."""

    def __init__(self, src: str, dst: str):
        super().__init__(f"link {src} -> {dst} is partitioned (injected)")
        self._msg = f"link {src} -> {dst} is partitioned (injected)"

    def code(self):
        return grpc.StatusCode.UNAVAILABLE

    def details(self):
        return self._msg


class FaultyGroups:
    """Transparent `Groups` wrapper with per-directed-link drop/delay.

    Wraps an EXISTING Groups (attribute delegation keeps membership,
    node id, tablet routing intact); only `pool()` is intercepted: the
    pooled client's `fault_check` hook fires before EVERY wire attempt
    (server/task.py Client._attempt), INSIDE the resilience layer's
    retry loop — so an injected LinkDown exercises the same
    retry/breaker machinery a real connect failure does.
    """

    def __init__(self, inner):
        self._inner = inner
        self._dropped: set[str] = set()       # peer addrs this node can't reach
        self._delay_s: dict[str, float] = {}  # peer addr → injected latency
        # clock-free delays (ROADMAP follow-on): instead of
        # time.sleep, a delayed link CONSUMES the ambient request
        # budget virtually (RequestContext.consume) — tight budgets
        # expire exactly as under a real stall, at zero wall time
        self.clock_free = False
        # instrument the INNER pool too: methods reached through
        # attribute delegation (call_group's read failover) bind the
        # inner Groups as self, so only hooking FaultyGroups.pool would
        # leave those legs fault-free
        inner_pool = inner.pool

        def hooked_pool(addr):
            c = inner_pool(addr)
            c.fault_check = lambda: self.check_link(addr)
            return c

        inner.pool = hooked_pool

    # -- fault control -------------------------------------------------------
    def drop_link(self, addr: str) -> None:
        """Partition the DIRECTED link this-node → addr."""
        self._dropped.add(addr)

    def heal_link(self, addr: str) -> None:
        self._dropped.discard(addr)
        self._delay_s.pop(addr, None)  # a healed link runs at full speed
        # the real pool may hold a channel poisoned by earlier failures
        self._inner.invalidate(addr)
        # a circuit breaker opened by the injected fault would refuse
        # the healed link until its cool-down expires — a heal restores
        # full connectivity, exactly like a peer restart does
        res = getattr(self._inner, "resilience", None)
        if res is not None:
            res.reset(addr)

    def heal_all(self) -> None:
        for a in list(self._dropped):
            self.heal_link(a)
        self._delay_s.clear()

    def delay_link(self, addr: str, seconds: float) -> None:
        self._delay_s[addr] = seconds

    def check_link(self, addr: str) -> None:
        if addr in self._dropped:
            raise LinkDown(self._inner.my_addr, addr)
        d = self._delay_s.get(addr)
        if d:
            if self.clock_free:
                from dgraph_tpu_torch.utils import deadline as dl
                from dgraph_tpu_torch.utils.metrics import METRICS
                METRICS.inc("fault_virtual_delays_total")
                ctx = dl.current()
                if ctx is not None:
                    ctx.consume(d)
                    # a budget the virtual stall exhausted dies HERE,
                    # exactly where a real sleep would have died
                    ctx.check("fault.delay")
            else:
                time.sleep(d)

    # -- Groups surface ------------------------------------------------------
    def pool(self, addr: str):
        return self._inner.pool(addr)  # hooked in __init__

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultSchedule:
    """Seeded randomized drop/heal/delay events over every DIRECTED link
    of a replica group — the nemesis of a Jepsen-shaped exploration
    (SURVEY §5: the reference leans on external Jepsen runs; the
    fuzzing harness in tests/test_partition_fuzz.py drives this).

    Deterministic per seed: the same seed regenerates the exact fault
    sequence, so a failing run replays bit-for-bit
    (DGRAPH_TPU_FUZZ_SEED=<seed>). Events are (op, src, dst, seconds)
    over node INDICES; `apply_event` maps them onto each node's
    FaultyGroups wrapper and tracks the current drop set so tests can
    ask which nodes are minority-isolated.

    `wal_trunc=True` adds WAL-truncation-race events to the schedule
    space (ROADMAP: "WAL truncation races"): node `src` crashes with a
    TORN WAL TAIL — its newest durable record is cut — and restarts.
    Records it acked into the cluster before the crash survive on its
    peers; the restarted node must heal the hole via FetchLog before
    serving, never expose the gap. The event carries no link state;
    the HARNESS performs the crash-restart through the `wal_trunc_cb`
    hook (the schedule stays transport-agnostic). Off by default so
    historical seeds keep their exact schedules.

    `deadline=True` adds DEADLINE-FAULT events: a read on node `src`
    runs with a tight budget (the `seconds` field) while the current
    link faults are live — a heal-in-progress FetchLog leg gets
    cancelled mid-flight. The harness performs the read through
    `deadline_cb(src, budget_s)` and asserts the lifecycle contract:
    the cancelled read raised retryably, leaked no pend, and a retry
    with a full budget serves or refuses CLEANLY. Also off by default
    (same seed-stability rule); armed extended families split the
    extended slice equally, in a fixed order, so a given (flags, seed)
    pair always regenerates identically — and historical seeds replay
    byte-for-byte when the newer flags are off.

    `clock_free=True` applies every delay event WITHOUT wall-clock
    sleeps (ROADMAP follow-on): the delayed link virtually consumes
    the ambient request budget (`RequestContext.consume`) and counts
    `fault_virtual_delays_total`, so a schedule heavy with 30 ms
    stalls fuzzes at full speed while tight budgets still expire
    exactly as under real stalls. Application-time only — the flag
    consumes NO rng draw, so historical-seed schedules replay
    byte-identically with it on or off.

    `crash=True` adds WHOLE-NODE CRASH faults: a `crash` event kills
    node `src` outright — it refuses all RPCs in both directions and
    loses every bit of volatile state (tablet caches, chain positions,
    staged-pend bookkeeping) — and a later `restart` event for the same
    node rebuilds it from its durable WAL/checkpoint (the torn-tail
    restart machinery), after which it must catch up via
    FetchLog/tablet_snapshot and serve again. The harness performs both
    through `crash_cb(src, up)`; crash events count
    `peer_crashes_total`. Generation pairs them: a crash on an
    already-down node regenerates as its restart.

    `disk=True` adds DISK-FAULT events (the fault fuzzing extended from
    the network to the disk):
    node `src`'s next durable write is damaged through the `vault` IO
    hook (store/vault.py `set_io_fault`) — `disk_bitflip` corrupts the
    written bytes (a bad sector under a WAL record: detected by the
    frame CRC as a torn tail on restart, healed via FetchLog),
    `disk_trunc` cuts the write short (a torn sector), and
    `disk_enospc` raises ENOSPC (the write refuses BEFORE any ack —
    the commit fails retryably, never applies unlogged). The harness
    performs the injection + any crash-restart through
    `disk_cb(src, kind)`; events count `fault_disk_events_total{kind=}`.
    Off by default — historical (flags, seed) schedules replay
    byte-identically (the golden-schedule tests pin this); armed, the
    extended slice re-splits equally with "disk" LAST in the fixed
    family order.

    `alloc=True` adds ALLOCATION-FAULT events (the memory governor's
    OOM lifecycle under fuzz): node `src`'s next governed
    device launch fails its allocation through the memgov process hook
    (utils/memgov.py `set_alloc_fault` — the vault `set_io_fault`
    idiom moved from the disk to the accelerator), exercising the
    evict-retry-once → sticky-degrade protocol under live partitions
    and crashes. The harness arms the one-shot hook through
    `alloc_cb(src)`; events count `fault_alloc_events_total`. Off by
    default — same seed-stability rule; armed, the family slots LAST
    after "disk" in the fixed order, so every historical (flags, seed)
    schedule replays byte-identically and new goldens pin the alloc
    space."""

    def __init__(self, seed: int, n_nodes: int, steps: int = 8,
                 max_delay_s: float = 0.03, wal_trunc: bool = False,
                 deadline: bool = False, crash: bool = False,
                 clock_free: bool = False, disk: bool = False,
                 alloc: bool = False):
        import random
        self.seed = seed
        self.n_nodes = n_nodes
        # clock-free delays change APPLICATION only, never generation:
        # the flag consumes no rng draw, so every historical (flags,
        # seed) pair replays byte-identically with it on or off (the
        # golden-schedule test pins this)
        self.clock_free = clock_free
        self.dropped: set[tuple[int, int]] = set()
        self.crashed: set[int] = set()  # nodes currently down (apply-time)
        rng = random.Random(seed)
        links = [(i, j) for i in range(n_nodes) for j in range(n_nodes)
                 if i != j]
        self.events: list[tuple[str, int, int, float]] = []
        families = [f for f, on in (("wal_trunc", wal_trunc),
                                    ("deadline", deadline),
                                    ("crash", crash),
                                    ("disk", disk),
                                    ("alloc", alloc)) if on]
        gen_down: set[int] = set()  # crash/restart pairing at generation
        for _ in range(steps):
            src, dst = rng.choice(links)
            r = rng.random()
            extended = None
            if r >= 0.85 and families:
                # the extended slice splits equally between the armed
                # families, in the fixed order above (a given
                # (flags, seed) pair always regenerates identically;
                # with only the historical flags armed the cut points
                # match the historical schedule exactly)
                idx = int((r - 0.85) / (0.15 / len(families)))
                extended = families[min(idx, len(families) - 1)]
            if extended == "wal_trunc":
                # a crash-restart with a torn tail; dst/seconds unused
                self.events.append(("wal_trunc", src, dst, 0.0))
                gen_down.discard(src)  # the restart brings it back
            elif extended == "deadline":
                # a read on src with this budget, under the live faults
                self.events.append(("deadline", src, dst,
                                    round(rng.uniform(0.001, 0.05), 4)))
            elif extended == "crash":
                if src in gen_down:
                    self.events.append(("restart", src, dst, 0.0))
                    gen_down.discard(src)
                else:
                    self.events.append(("crash", src, dst, 0.0))
                    gen_down.add(src)
            elif extended == "disk":
                # sub-kind draw happens only inside the disk branch, so
                # schedules with the flag off never consume it
                kind = rng.choice(("bitflip", "trunc", "enospc"))
                self.events.append((f"disk_{kind}", src, dst, 0.0))
                if kind != "enospc":
                    # bitflip/trunc damage durable state; the harness
                    # crash-restarts the node so recovery runs
                    gen_down.discard(src)
            elif extended == "alloc":
                # one injected allocation failure on src's next governed
                # launch; dst/seconds unused, no extra rng draw — the
                # alloc family never perturbs other families' schedules
                self.events.append(("alloc", src, dst, 0.0))
            elif r < 0.40:
                self.events.append(("drop", src, dst, 0.0))
            elif r < 0.70:
                self.events.append(("heal", src, dst, 0.0))
            else:
                self.events.append(("delay", src, dst,
                                    round(rng.uniform(0.002,
                                                      max_delay_s), 4)))

    def __repr__(self) -> str:
        return (f"FaultSchedule(seed={self.seed}, "
                f"n_nodes={self.n_nodes}, events={self.events})")

    def apply_event(self, ev: tuple[str, int, int, float],
                    faulty_groups, addrs, wal_trunc_cb=None,
                    deadline_cb=None, crash_cb=None,
                    disk_cb=None, alloc_cb=None) -> None:
        """Apply one event; `faulty_groups[i]` is node i's FaultyGroups
        wrapper, `addrs[i]` its address. `wal_trunc_cb(src)` performs a
        crash-restart-with-torn-tail of node src; `deadline_cb(src,
        budget_s)` runs the harness's tight-budget read on node src;
        `crash_cb(src, up)` kills (up=False) or rebuilds-from-WAL
        (up=True) node src; `disk_cb(src, kind)` injects one
        bitflip/trunc/enospc write fault on node src through the vault
        IO hook; `alloc_cb(src)` arms one allocation failure on node
        src's next governed launch through the memgov process hook (any
        callback is skipped when the harness passes None)."""
        from dgraph_tpu_torch.utils.metrics import METRICS
        op, src, dst, secs = ev
        if op.startswith("disk_"):
            if disk_cb is not None and src not in self.crashed:
                METRICS.inc("fault_disk_events_total", kind=op[5:])
                disk_cb(src, op[5:])
            return
        if op == "alloc":
            if alloc_cb is not None and src not in self.crashed:
                METRICS.inc("fault_alloc_events_total")
                alloc_cb(src)
            return
        if op == "deadline":
            if deadline_cb is not None:
                deadline_cb(src, secs)
            return
        if op == "wal_trunc":
            if wal_trunc_cb is not None:
                # the node's links come back clean after a restart
                faulty_groups[src].heal_all()
                self.dropped = {(s, d) for s, d in self.dropped
                                if s != src}
                self.crashed.discard(src)
                wal_trunc_cb(src)
            return
        if op == "crash":
            if crash_cb is not None and src not in self.crashed:
                self.crashed.add(src)
                METRICS.inc("peer_crashes_total")
                crash_cb(src, False)
            return
        if op == "restart":
            if crash_cb is not None and src in self.crashed:
                # the restarted node's links come back clean
                faulty_groups[src].heal_all()
                self.dropped = {(s, d) for s, d in self.dropped
                                if s != src}
                self.crashed.discard(src)
                crash_cb(src, True)
            return
        fg = faulty_groups[src]
        if op == "drop":
            fg.drop_link(addrs[dst])
            self.dropped.add((src, dst))
        elif op == "heal":
            fg.heal_link(addrs[dst])
            self.dropped.discard((src, dst))
        else:
            fg.clock_free = self.clock_free
            fg.delay_link(addrs[dst], secs)

    def heal_all(self, faulty_groups, crash_cb=None) -> None:
        for fg in faulty_groups:
            fg.heal_all()
        self.dropped.clear()
        # crashed nodes restart as part of the global heal (the harness
        # passes the same crash_cb apply_event used)
        if crash_cb is not None:
            for src in sorted(self.crashed):
                crash_cb(src, True)
            self.crashed.clear()

    def isolated(self, i: int) -> bool:
        """True when node i currently reaches NO peer: its commits must
        refuse with NoQuorum and its reads with ReadUnavailable (the
        minority side of the partition). A live node whose every peer
        CRASHED is just as alone as one whose links all dropped."""
        return all((i, j) in self.dropped or j in self.crashed
                   for j in range(self.n_nodes) if j != i)
