"""Fleet observability: one correlated view of every node.

Port of `dgraph_tpu/server/fleet.py`:

* `node_snapshot(alpha)` — ONE node's fleet fragment: identity (addr,
  node id, group, build, uptime), span/propagation counters, the full
  metrics exposition, the cost-digest state (integer, exactly
  mergeable), the breaker states, the flight recorder's watchdog and
  dump counts, the race and lock-cycle gate counts, the time-series
  digest and the SLO states. Served over the worker transport by the
  DebugFleet RPC.

* `fleet_snapshot(alpha)` — the `GET /debug/fleet` document: fan out
  over every known cluster node through the pooled clients (so each
  leg rides the per-peer circuit breaker + retry policy), bounded by
  one overall budget (DebugFleet forwards the remaining budget as its
  gRPC deadline), and merge: cost digests combine EXACTLY, metrics
  expositions concatenate with an `instance` label per series. A dark
  or breaker-open peer degrades to an entry in `errors` — the snapshot
  is partial, never a 500. Per-node SLO burn rates fold into one
  worst-burn-per-objective view (`slo.worst_burn`).

* identity metrics — `build_info` and `process_uptime_s`, refreshed on
  every exposition render, so scrapes always carry a live uptime.
  `build_info`'s labels are the package version, the torch version and
  the device type the process serves on (`cuda` when a card is present,
  else `cpu`), where the reference's name the jax version and backend
  (ROADMAP Queue 3).
"""

from __future__ import annotations

from dgraph_tpu_torch import __version__
from dgraph_tpu_torch.utils import costprofile, flightrec, locks, tracing
from dgraph_tpu_torch.utils import deadline as dl
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["build_labels", "refresh_identity_metrics", "node_snapshot",
           "fleet_snapshot", "merge_exposition", "FLEET_BUDGET_MS"]

FLEET_BUDGET_MS = 2000.0  # default whole-fan-out budget

_START_MONO = dl.monotonic_s()
_BUILD: dict | None = None


def build_labels() -> dict:
    """The build_info identity labels, resolved once: package version,
    torch version and the device type."""
    global _BUILD
    if _BUILD is None:
        import torch
        _BUILD = {"version": __version__, "torch": torch.__version__,
                  "device": "cuda" if torch.cuda.is_available() else "cpu"}
    return _BUILD


def refresh_identity_metrics() -> None:
    """Set the build/uptime identity gauges. Called before every
    exposition render, so `process_uptime_s` is live, not a boot-time
    constant."""
    b = build_labels()
    METRICS.set_gauge("build_info", 1.0, version=b["version"],
                      torch=b["torch"], device=b["device"])
    METRICS.set_gauge("process_uptime_s",
                      round(dl.monotonic_s() - _START_MONO, 3))


def node_snapshot(alpha) -> dict:
    """One node's fleet fragment (the DebugFleet RPC payload)."""
    refresh_identity_metrics()
    groups = getattr(alpha, "groups", None)
    res = getattr(groups, "resilience", None) if groups is not None \
        else None
    races = locks.RACES.snapshot()
    lock_graph = locks.GRAPH.snapshot()
    fr = flightrec.state(1)  # watchdog/dump status; ring stays local
    return {
        "addr": groups.my_addr if groups is not None else "local",
        "node_id": groups.node_id if groups is not None else 0,
        "group": groups.gid if groups is not None else 0,
        "build": dict(build_labels()),
        "uptime_s": round(dl.monotonic_s() - _START_MONO, 3),
        "spans": tracing.stats(),
        "metrics": METRICS.render(),
        "costs": costprofile.COSTS.to_state(),
        "breakers": res.snapshot() if res is not None else {},
        "watchdog": fr.get("watchdog", {"armed": False}),
        "flight": {"armed": fr["armed"], "inflight": fr["inflight"],
                   "dumps": len(fr["dumps"])},
        "gates": {"races": races.get("races_total", 0),
                  "lock_cycles": len(lock_graph.get("cycles", ()))},
        # the recent-window digest + SLO states, so the fleet merge can
        # answer "which node is burning budget" without another pull
        "timeseries": _timeseries_fragment(),
        "slo": _slo_fragment(),
    }


def _timeseries_fragment() -> dict | None:
    from dgraph_tpu_torch.utils import timeseries
    s = timeseries.state()
    if s is None:
        return None
    return s.ring.summary(60.0)


def _slo_fragment() -> dict | None:
    from dgraph_tpu_torch.utils import slo
    eng = slo.ENGINE
    if eng is None:
        return None
    st = eng.status()
    return {"states": st["states"],
            "breaches_total": st["breaches_total"]}


def _with_instance(line: str, instance: str) -> str:
    """One exposition sample line with an `instance` label spliced in
    (first position, so escaping of the existing labels is
    untouched)."""
    name, _, val = line.partition(" ")
    esc = instance.replace("\\", "\\\\").replace('"', '\\"')
    if "{" in name:
        head, rest = name.split("{", 1)
        return f'{head}{{instance="{esc}",{rest} {val}'
    return f'{name}{{instance="{esc}"}} {val}'


def merge_exposition(per_node: dict[str, str]) -> str:
    """Per-node expositions → one instance-labeled text block. TYPE
    headers dedupe across nodes; every sample gains
    `instance="<addr>"`. Each node's exposition already rode its own
    cardinality guard, so the merged series count is bounded by
    nodes × the per-node cap."""
    out: list[str] = []
    seen_types: set[str] = set()
    for inst in sorted(per_node):
        for line in per_node[inst].splitlines():
            if not line.strip():
                continue
            if line.startswith("# TYPE"):
                if line not in seen_types:
                    seen_types.add(line)
                    out.append(line)
                continue
            if line.startswith("#"):
                continue
            out.append(_with_instance(line, inst))
    return "\n".join(out) + "\n"


def fleet_snapshot(alpha, budget_ms: float = FLEET_BUDGET_MS) -> dict:
    """The `GET /debug/fleet` document. Degraded-not-failed: a peer
    that refuses (dark, breaker-open, or past the budget) lands in
    `errors` keyed by its address; everything reachable still merges.
    The whole fan-out shares ONE request budget — DebugFleet is
    budget-forwarded, so the remaining time rides each leg's gRPC
    deadline and a wedged peer cannot stall the snapshot."""
    local = node_snapshot(alpha)
    me = local["addr"]
    fragments: dict[str, dict] = {me: local}
    errors: dict[str, str] = {}
    groups = getattr(alpha, "groups", None)
    if groups is not None:
        with dl.activate(dl.RequestContext(budget_ms)):
            for addr in groups.known_addrs():
                if addr == me:
                    continue
                try:
                    fragments[addr] = groups.pool(addr).debug_fleet()
                    METRICS.inc("fleet_fanout_total", outcome="ok")
                except Exception as e:  # noqa: BLE001 — degrade, never 500
                    errors[addr] = f"{type(e).__name__}: {e}"[:300]
                    METRICS.inc("fleet_fanout_total", outcome="error")
    merged = costprofile.Aggregator()
    for frag in fragments.values():
        try:
            merged.merge(costprofile.Aggregator.from_state(
                frag.get("costs") or {}))
        except Exception:  # noqa: BLE001 — a malformed fragment merges as empty
            pass
    # per-node burn rates fold into one worst-burn-per-objective view;
    # nodes with no engine armed are absent (partial, never a 500)
    slo_merged: dict[str, dict] = {}
    breaches_total = 0
    for addr, frag in fragments.items():
        sl = frag.get("slo") or {}
        breaches_total += sl.get("breaches_total", 0)
        for name, st in (sl.get("states") or {}).items():
            for win, w in (st.get("windows") or {}).items():
                cur = slo_merged.setdefault(name, {}).get(win)
                if cur is None or w.get("burn", 0) > cur["burn"]:
                    slo_merged[name][win] = {
                        "burn": w.get("burn", 0),
                        "breached": w.get("breached", False),
                        "node": addr}
    return {
        "self": me,
        "nodes": {addr: {k: v for k, v in frag.items()
                         if k not in ("metrics", "costs")}
                  for addr, frag in fragments.items()},
        "errors": errors,
        "slo": {"worst_burn": slo_merged,
                "breaches_total": breaches_total},
        # exact merge: integer digest state is associative, so this is
        # bit-identical to merging the same fragments in-process (the
        # tier-1 test pins it against a local Aggregator.merge)
        "costs": merged.to_doc(top_n=10),
        "costs_state": merged.to_state(),
        "metrics": merge_exposition(
            {addr: frag.get("metrics", "")
             for addr, frag in fragments.items()}),
    }
