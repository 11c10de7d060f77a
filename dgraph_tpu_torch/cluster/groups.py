"""Groups: cluster membership, tablet routing, connection pooling.

Port of `dgraph_tpu/cluster/groups.py`, with a plain `threading.Lock`.

Reference parity: `worker/groups.go` (`groups()`, `BelongsTo`, tablet map
kept fresh from Zero's membership stream) + `conn/pool.go` (one cached
gRPC channel per peer address, reused by every request). Membership is
refreshed by polling Zero's counter; tablet claims go through ShouldServe
exactly as the reference's first-asker rule.
"""

from __future__ import annotations

import threading

import grpc

from dgraph_tpu_torch.cluster.resilience import PeerTable
from dgraph_tpu_torch.cluster.zero import ZeroClient
from dgraph_tpu_torch.utils.metrics import METRICS


class Groups:
    def __init__(self, zero: ZeroClient, my_addr: str, group: int = 0,
                 max_ts: int = 0, max_uid: int = 0,
                 breaker_threshold: int = 5,
                 breaker_cooldown_ms: float = 500.0,
                 rpc_retries: int = 2):
        self.zero = zero
        self.my_addr = my_addr
        self.node_id, self.gid = zero.connect(my_addr, group,
                                              max_ts=max_ts,
                                              max_uid=max_uid)
        # this node's view of every peer it dials: circuit breakers +
        # retry policy shared by all pooled clients (--breaker_threshold,
        # --breaker_cooldown_ms, --rpc_retries)
        self.resilience = PeerTable(threshold=breaker_threshold,
                                    cooldown_ms=breaker_cooldown_ms,
                                    retries=rpc_retries)
        self._lock = threading.Lock()
        self._pools: dict[str, object] = {}
        self._tablets: dict[str, int] = {}
        self._groups: dict[int, dict[int, str]] = {}
        self._counter = -1
        self.refresh()

    # -- membership ----------------------------------------------------------
    def refresh(self) -> None:
        st = self.zero.membership()
        with self._lock:
            self._counter = int(st.counter)
            self._tablets = {}
            self._groups = {}
            for gid, g in st.groups.items():
                self._groups[int(gid)] = {int(n): a
                                          for n, a in g.nodes.items()}
                for p in g.tablets:
                    self._tablets[p] = int(gid)

    def tablet_owner(self, pred: str, claim: bool = True) -> int | None:
        """Owning group of a predicate; unowned predicates are claimed for
        THIS group (reference: ShouldServe first-asker)."""
        with self._lock:
            owner = self._tablets.get(pred)
        if owner is not None:
            return owner
        self.refresh()
        with self._lock:
            owner = self._tablets.get(pred)
        if owner is None and claim:
            owner = self.zero.should_serve(pred, self.gid)
            self.refresh()
        return owner

    def serves(self, pred: str) -> bool:
        return self.tablet_owner(pred) == self.gid

    def group_addrs(self, gid: int) -> list[str]:
        with self._lock:
            return sorted(self._groups.get(gid, {}).values())

    def addr_of_node(self, node_id: int) -> str | None:
        """Address of a node id anywhere in the cluster (broadcast-chain
        catch-up needs the origin's address)."""
        with self._lock:
            for nodes in self._groups.values():
                if node_id in nodes:
                    return nodes[node_id]
        self.refresh()
        with self._lock:
            for nodes in self._groups.values():
                if node_id in nodes:
                    return nodes[node_id]
        return None

    def node_of_addr(self, addr: str) -> int | None:
        """Node id at an address (the read gate tracks chains per ORIGIN
        node id; an unreachable peer's id comes from membership)."""
        with self._lock:
            for nodes in self._groups.values():
                for nid, a in nodes.items():
                    if a == addr:
                        return nid
        return None

    def other_addrs(self) -> list[str]:
        """Every node in the cluster except this one (broadcast targets).
        Always re-polls membership first: a commit must reach nodes that
        joined after our last refresh (reference: the membership stream
        keeps this continuously fresh; polling at each broadcast is the
        same guarantee at our scale)."""
        self.refresh()
        with self._lock:
            return sorted({a for nodes in self._groups.values()
                           for a in nodes.values() if a != self.my_addr})

    def known_addrs(self) -> list[str]:
        """Every node in the cluster INCLUDING this one — the fleet
        fan-out's target list (server/fleet.py). Re-polls membership
        first, like other_addrs: a fleet snapshot must see nodes that
        joined after our last refresh."""
        self.refresh()
        with self._lock:
            return sorted({a for nodes in self._groups.values()
                           for a in nodes.values()})

    def peer_health(self) -> dict[str, dict]:
        """This node's breaker/latency view of every peer it dials —
        the `/debug/peers` data in heartbeat form (Zero's
        tablet-move decisions read it via ReportHealth, so moves never
        target a peer this node's breaker already knows is down)."""
        out = {}
        for addr, p in self.resilience.snapshot().items():
            out[addr] = {"state": p["state"],
                         "ema_latency_us": p["ema_latency_us"]}
        return out

    # -- conn pooling ---------------------------------------------------------
    def pool(self, addr: str):
        """Cached worker client per peer address (conn/pool.go). Every
        pooled client shares this node's PeerTable, so its calls run
        under the per-peer breaker + retry policy."""
        from dgraph_tpu_torch.server.task import Client
        with self._lock:
            c = self._pools.get(addr)
            if c is None:
                c = self._pools[addr] = Client(
                    addr, resilience=self.resilience, peer_addr=addr)
            return c

    def invalidate(self, addr: str) -> None:
        """Drop a pooled channel after a failure: a cached grpc channel
        sits in reconnect backoff and fails fast long after the peer is
        healthy again; a fresh dial on the next call finds it immediately
        (reference: conn/pool.go re-dials dead connections)."""
        with self._lock:
            c = self._pools.pop(addr, None)
        if c is not None:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — already broken
                pass

    def call_group(self, gid: int, fn, exclude=(), rpc: str = ""):
        """Run `fn(client)` against any live node of a group, trying
        replicas in order — read failover (reference: reads served by any
        replica; pool pick + retry). `exclude` skips peers known to be
        lagging (suspects from a failed broadcast); peers whose circuit
        breaker is OPEN are tried last (they fail instantly, but a
        possibly-stale or known-dead answer beats none — when every
        replica is exhausted the caller's refusal, ReadUnavailable,
        stands). A call served by anyone but the preferred replica
        counts `failover_total{rpc=}`."""
        last = None
        addrs = self.group_addrs(gid)
        fresh = [a for a in addrs if a not in exclude]
        ordered = ([a for a in fresh if self.resilience.available(a)]
                   + [a for a in fresh
                      if not self.resilience.available(a)]
                   + [a for a in addrs if a in exclude])
        # the historical preference is the first non-excluded replica:
        # serving from anyone else — because the preferred breaker is
        # open OR its attempt failed — is a failover
        preferred = fresh[0] if fresh else (ordered[0] if ordered
                                            else None)
        for addr in ordered:
            try:
                out = fn(self.pool(addr))
            except grpc.RpcError as e:
                last = e
                continue
            if addr != preferred and rpc:
                METRICS.inc("failover_total", rpc=rpc)
                from dgraph_tpu_torch.utils import costprofile
                costprofile.add("rpc_failovers", 1)
            return out
        raise last if last is not None else RuntimeError(
            f"group {gid} has no nodes")
