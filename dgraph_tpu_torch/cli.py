"""CLI process entry: `python -m dgraph_tpu_torch <subcommand>`.

Port of `dgraph_tpu/cli.py`. Reference parity: `dgraph/cmd/root.go`
cobra subcommands — `alpha` (data server), `zero` (cluster oracle
service), `live` / `bulk` (loaders), `export`, `debug` (snapshot
inspector), `version`. argparse stands in for cobra; every flag maps
onto the typed configs in utils/config.py.

The port's own rules:
* `alpha` and `live`, the verbs that build an Alpha that serves
  queries, take `--device` (default `cuda`). Without a card they exit
  non-zero before they create or touch the posting directory, unless
  given `--device cpu`. `backup` opens its Alpha on the CPU as
  `server/backup.py` does; `bulk`, `restore`, `export` and `debug` run
  host code.
* `--mesh-devices N` serves the engine over a mesh of this process's
  devices (`parallel/mesh.make_mesh`): the first N cards, -1 all of
  them; with `--device cpu`, N shards of the CPU (-1: one). With
  `--jax-coordinator host:port` (or JAX_COORDINATOR_ADDRESS) and the
  env pair JAX_NUM_PROCESSES / JAX_PROCESS_ID, the process joins a
  process group first (`mesh.init_distributed`) and N counts the
  global device list, every process's in rank order (-1: all of
  them); each process offers DGRAPH_TPU_LOCAL_SHARDS shards (default
  1) of its card, or of the CPU with `--device cpu`. The collectives
  run over NCCL when every process has cards of its own, else over
  gloo; the log names the backend. A count above the devices exits
  non-zero, naming the device count, before the posting directory is
  touched, and so does a process left without a shard. Serving across
  processes is SPMD: every process must receive the same mesh
  requests in the same order, so `--max_inflight` (admission control,
  which sheds per process) exits non-zero beside a coordinator.
* Importing this module loads no grpc: the `alpha` and `zero` verbs
  import the transport inside their functions.
"""

from __future__ import annotations

import argparse
import json
import sys

from dgraph_tpu_torch import __version__
from dgraph_tpu_torch.utils import logging as xlog
from dgraph_tpu_torch.utils.config import AlphaConfig, load_config

# consecutive heartbeat failures before the loop escalates from a
# debug-level note to an ERROR log: a dead Zero link must be VISIBLE
# (a silent heartbeat failure eventually gets this alpha marked dead
# by Zero's liveness sweep with no local trace of why)
HEARTBEAT_ERROR_AFTER = 3


def run_heartbeat_loop(kind: str, interval_s: float, step, log,
                       stop=None) -> None:
    """Drive one heartbeat `step()` every `interval_s`, surviving
    failures — but never silently: every failure counts
    `heartbeat_failures_total{kind=}`, and `HEARTBEAT_ERROR_AFTER`
    consecutive failures escalate to an error-level log (once per
    outage, re-armed by the next success). `stop` (threading.Event)
    ends the loop — tests drive it; the CLI never sets it."""
    import threading

    from dgraph_tpu_torch.utils.metrics import METRICS
    stop = stop or threading.Event()
    fails = 0
    while not stop.wait(interval_s):
        try:
            step()
            if fails >= HEARTBEAT_ERROR_AFTER:
                log.info("%s heartbeat recovered after %d failures",
                         kind, fails)
            fails = 0
        except Exception:  # noqa: BLE001 — the loop must outlive faults
            fails += 1
            METRICS.inc("heartbeat_failures_total", kind=kind)
            if fails == HEARTBEAT_ERROR_AFTER:
                log.error(
                    "%s heartbeat failed %d times in a row — the zero "
                    "link is likely dead (this node will be marked "
                    "dead by zero's liveness sweep if this persists)",
                    kind, fails, exc_info=True)
            else:
                log.debug("%s heartbeat failed (%d consecutive)",
                          kind, fails, exc_info=True)


# an alpha started beside its Zero waits this long for Zero to listen,
# as upstream Dgraph's alpha retries its Zero connection; the reference
# exits at once (ROADMAP Queue 3)
ZERO_JOIN_WAIT_S = 60.0

# on SIGINT, how long the requests in flight may take to end before the
# final checkpoint goes ahead without them
REQUEST_DRAIN_S = 30.0

MESH_TOO_WIDE = ("alpha: {flag} asks for {want} devices and this machine "
                 "has {have}")


def _alpha_mesh(n: int, device: str, coordinator: str | None):
    """The alpha's mesh for `--mesh-devices n` (n != 0) on `device`: over
    this process's devices, or, with a coordinator (the flag or
    JAX_COORDINATOR_ADDRESS), over the first n of every process's once
    this process has joined the group. Exits naming the device count
    when n asks for more devices than there are, and when the mesh
    leaves this process without a shard (checked before any directory
    is touched)."""
    import os

    import torch

    from dgraph_tpu_torch.parallel import mesh as pmesh
    flag = f"--mesh-devices {n}"
    if coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        if torch.device(device).type == "cuda":
            _require_device(device, "alpha")
        try:
            pmesh.init_distributed(coordinator)
        except ValueError as e:
            raise SystemExit(f"alpha: --jax-coordinator: {e}") from None
        try:
            mesh = pmesh.make_mesh(None if n < 0 else n, device=device)
        except ValueError as e:
            raise SystemExit(f"alpha: {flag}: {e}") from None
        if not mesh.local:
            raise SystemExit(f"alpha: {flag} leaves process {mesh.rank} "
                             f"without a shard of the mesh")
        return mesh
    if torch.device(device).type == "cpu":
        return pmesh.make_mesh(n if n > 0 else 1, device="cpu")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have or have == 0:
        raise SystemExit(MESH_TOO_WIDE.format(
            flag=flag, want=n if n > 0 else "all", have=have))
    return pmesh.make_mesh(None if n < 0 else n)


def _require_device(device: str, verb: str) -> None:
    """Exit non-zero when `device` names the card and there is none:
    the verb then never touches its posting directory."""
    import torch
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"{verb}: no CUDA device is available; pass "
                         f"--device cpu to serve on the CPU")


def _join_zero(join, target: str, log):
    """`join()` (the cluster join's Connect), retried each second while
    Zero is not yet listening, for ZERO_JOIN_WAIT_S at most; any other
    failure raises at once."""
    import time

    import grpc
    deadline = time.monotonic() + ZERO_JOIN_WAIT_S
    # graftlint: allow(retry-deadline): only UNAVAILABLE (Zero not yet
    # listening) is retried, for ZERO_JOIN_WAIT_S; DEADLINE_EXCEEDED and
    # every other code raise at once, and the join spends no request
    # budget
    while True:
        try:
            return join()
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.UNAVAILABLE or \
                    time.monotonic() > deadline:
                raise
            log.warning("zero %s unavailable; retrying the join in 1 s",
                        target)
            time.sleep(1.0)


def _drain_requests(log) -> None:
    """Wait, REQUEST_DRAIN_S at most, until no request is in flight (the
    flight recorder, which the alpha verb arms, registers each one)."""
    import time

    from dgraph_tpu_torch.utils import flightrec
    deadline = time.monotonic() + REQUEST_DRAIN_S
    while n := flightrec.state(0)["inflight"]:
        if time.monotonic() > deadline:
            log.warning("%d requests still in flight after %.0f s", n,
                        REQUEST_DRAIN_S)
            return
        time.sleep(0.05)


def cmd_alpha(args) -> int:
    import os

    overrides = {
        "p_dir": args.p, "http_port": args.http_port,
        "grpc_port": args.grpc_port, "log_level": args.log_level,
        "mesh_devices": args.mesh_devices,
        "device": args.device,
        "encryption_key_file": args.encryption_key_file,
        "encryption_strict": args.encryption_strict or None,
        "memory_budget_mb": args.memory_budget_mb,
        "device_budget_mb": args.device_budget_mb,
        "host_cache_budget_mb": args.host_cache_budget_mb,
        "slow_query_ms": args.slow_query_ms,
        "trace_dir": args.trace_dir,
        "trace_export": args.trace_export,
        "rollup_after": args.rollup_after,
        "checkpoint_every_s": args.checkpoint_every_s,
        "maintenance_pacing_ms": args.maintenance_pacing_ms,
        "max_inflight": args.max_inflight,
        "queue_depth": args.queue_depth,
        "default_deadline_ms": args.default_deadline_ms,
        "cost_priors": args.cost_priors,
        "ts_interval_s": args.ts_interval_s,
        "ts_ring_points": args.ts_ring_points,
        "slo_spec": args.slo_spec,
        "forecast_shedding": args.forecast_shedding,
        "telemetry_push_url": args.telemetry_push_url,
        "telemetry_push_interval_s": args.telemetry_push_interval_s,
        "diag_dir": args.diag_dir,
        "stall_factor": args.stall_factor,
        "stall_floor_ms": args.stall_floor_ms,
        "rpc_retries": args.rpc_retries,
        "breaker_threshold": args.breaker_threshold,
        "breaker_cooldown_ms": args.breaker_cooldown_ms}
    if args.store:
        # grouped superflag (reference: z.SuperFlag, e.g.
        # --badger "compression=zstd; numgoroutines=8")
        from dgraph_tpu_torch.utils.config import parse_superflag
        probe = AlphaConfig()
        for k, v in parse_superflag(args.store).items():
            if not hasattr(probe, k):
                raise SystemExit(f"unknown --store key {k!r}")
            if overrides.get(k) is None:  # dedicated flags win
                overrides[k] = v
    cfg = load_config(AlphaConfig, args.config, overrides)
    if args.jax_coordinator and not cfg.mesh_devices:
        raise SystemExit(f"alpha: --jax-coordinator {args.jax_coordinator} "
                         f"joins a mesh across processes: give "
                         f"--mesh-devices too")
    if cfg.max_inflight > 0 and (args.jax_coordinator or os.environ.get(
            "JAX_COORDINATOR_ADDRESS")):
        raise SystemExit(f"alpha: --max_inflight {cfg.max_inflight}: "
                         f"admission control sheds per process, and a "
                         f"request one process sheds and another serves "
                         f"puts the ranks of a mesh across processes out "
                         f"of step; serve it without admission control")
    # SPMD serving: the engine runs its hops sharded over the mesh
    mesh = (_alpha_mesh(cfg.mesh_devices, cfg.device, args.jax_coordinator)
            if cfg.mesh_devices else None)
    _require_device(cfg.device, "alpha")
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.server.http import make_http_server, serve_background
    from dgraph_tpu_torch.server.task import make_server

    xlog.setup(cfg.log_level)
    log = xlog.get("alpha")
    if cfg.encryption_key_file:
        # at-rest encryption for every checkpoint file and WAL record
        # this process writes or reads (reference: ee encryption,
        # --encryption key-file=)
        from dgraph_tpu_torch.store import vault
        vault.load_key_file(cfg.encryption_key_file,
                            strict=cfg.encryption_strict)
        log.info("encryption-at-rest enabled (strict=%s)",
                 cfg.encryption_strict)

    # checkpoint + WAL replay boot: every commit that reached disk before
    # a crash is recovered (reference: badger open + raft WAL restore)
    if mesh is not None:
        log.info("device mesh: %d shards over %s", mesh.size,
                 ", ".join(sorted({str(d) for d in mesh.devices})))
    if mesh is not None and mesh.spans_processes:
        from dgraph_tpu_torch.parallel.mesh import (process_count,
                                                    process_index)
        log.info("multi-process runtime: process %d/%d", process_index(),
                 process_count())
        log.info("device mesh across %d processes over %s: this process "
                 "holds shards %s", len(mesh.owners), mesh.backend,
                 list(mesh.local))
    alpha = Alpha.open(cfg.p_dir, device_threshold=cfg.device_threshold,
                       memory_budget=(cfg.memory_budget_mb << 20)
                       if cfg.memory_budget_mb else None,
                       device=cfg.device, mesh=mesh)
    alpha.slow_query_ms = cfg.slow_query_ms
    # unified cache governor (utils/memgov.py): arm the process-wide
    # byte budgets — every registered cache (fused programs, ELL
    # plans/kernels, device relations, tablet adapters, LazyPreds
    # residency) evicts above 90% of its kind's budget down to 70%,
    # lowest predicted recompute-value-per-byte first; governed launch
    # sites absorb allocation failures with one evict-retry, then
    # sticky-degrade the shape to the staged/host route
    if cfg.device_budget_mb or cfg.host_cache_budget_mb:
        from dgraph_tpu_torch.utils import memgov
        memgov.GOVERNOR.set_budgets(
            device_bytes=cfg.device_budget_mb << 20,
            host_bytes=cfg.host_cache_budget_mb << 20)
        log.info("memory governor armed: device_budget_mb=%d "
                 "host_cache_budget_mb=%d (caches: %s)",
                 cfg.device_budget_mb, cfg.host_cache_budget_mb,
                 ",".join(sorted(memgov.GOVERNOR.registered_names())))
    # request lifecycle: admission control (token limit + bounded FIFO
    # queue + shedding) and the default per-request budget
    if cfg.max_inflight > 0:
        alpha.attach_admission(cfg.max_inflight, cfg.queue_depth,
                               default_deadline_ms=cfg.default_deadline_ms)
        log.info("admission control armed: max_inflight=%d "
                 "queue_depth=%d default_deadline_ms=%.0f",
                 cfg.max_inflight, cfg.queue_depth,
                 cfg.default_deadline_ms)
    elif cfg.default_deadline_ms:
        alpha.default_deadline_ms = cfg.default_deadline_ms
        log.info("default request deadline: %.0f ms",
                 cfg.default_deadline_ms)
    # cost-prior scheduling (utils/costprior.py): per-shape predicted
    # cost feeds admission shedding/hints, batch-plan ordering, and the
    # placement heartbeat; --no-cost_priors restores count/EMA behavior.
    # The port's switch is process-wide (the reference also keeps a
    # per-Alpha one); this process serves one Alpha
    from dgraph_tpu_torch.utils import costprior
    costprior.set_enabled(cfg.cost_priors)
    if not cfg.cost_priors:
        log.info("cost-prior scheduling DISABLED (--no-cost_priors): "
                 "admission/planning fall back to count + lane EMA")
    if cfg.slow_query_ms:
        log.info("slow-query log armed at %d ms", cfg.slow_query_ms)
    if cfg.trace_dir:
        # device-timeline capture: spans marked device=True also write
        # torch.profiler traces (Chrome) under this dir; POST
        # /debug/profile starts/stops on-demand captures under it too
        from dgraph_tpu_torch.utils import tracing
        tracing.enable_device_trace(cfg.trace_dir)
        log.info("device trace capture armed: %s", cfg.trace_dir)
    pusher = None
    if cfg.telemetry_push_url:
        # live span + cost-record streaming to an external collector
        # (bounded buffer, retry-with-backoff, counted drops); unset =
        # graceful no-op — the historical shutdown/pull-only posture
        from dgraph_tpu_torch.utils.push import TelemetryPusher
        pusher = TelemetryPusher(
            cfg.telemetry_push_url,
            interval_s=cfg.telemetry_push_interval_s).start()
        log.info("telemetry push armed: %s every %.1fs",
                 cfg.telemetry_push_url, cfg.telemetry_push_interval_s)
    if args.acl_secret_file:
        # ACL enforcement (reference: ee/acl --acl_secret_file): groot
        # bootstrap + token-gated endpoints
        from dgraph_tpu_torch.server.acl import AclManager
        secret = open(args.acl_secret_file).read().strip()
        alpha.acl = AclManager(alpha, secret)
        alpha.acl.ensure_groot()
        log.info("ACL enforcement enabled")
    log.info("opened %s: %d nodes on %s", cfg.p_dir,
             alpha.mvcc.base.n_nodes, alpha.device)

    grpc_server, grpc_port = make_server(
        alpha, f"{cfg.http_addr}:{cfg.grpc_port}")
    grpc_server.start()
    if args.zero:
        # cluster mode: Zero leases + membership + tablet routing
        from dgraph_tpu_torch.cluster.groups import Groups
        from dgraph_tpu_torch.cluster.zero import RemoteOracle, ZeroClient
        # capture the REPLAYED watermarks before swapping oracles: the
        # local oracle was bumped past every WAL-tail commit_ts/uid during
        # Alpha.open, and handing Zero anything lower would let it lease
        # duplicate timestamps/uids after a crash-restart rejoin
        replayed_ts = alpha.oracle.max_assigned
        replayed_uid = alpha.oracle.max_uid
        zero = ZeroClient(args.zero)
        alpha.oracle = RemoteOracle(zero)
        alpha.xidmap._oracle = alpha.oracle
        alpha.groups = _join_zero(lambda: Groups(
            zero, f"{cfg.http_addr}:{grpc_port}", group=args.group,
            max_ts=max(alpha.mvcc.base_ts, replayed_ts),
            max_uid=replayed_uid,
            breaker_threshold=cfg.breaker_threshold,
            breaker_cooldown_ms=cfg.breaker_cooldown_ms,
            rpc_retries=cfg.rpc_retries), args.zero, log)
        log.info("joined cluster: node=%d group=%d",
                 alpha.groups.node_id, alpha.groups.gid)
        # rejoin catch-up: pull any WAL tail we missed while down, then
        # force freshness re-checks on every foreign tablet (reference:
        # restarted follower replays the leader's log + snapshot)
        if alpha.groups.other_addrs():
            alpha.resync_on_join()

        def liveness_step():
            # liveness ping + applied watermarks (reference: membership
            # heartbeat; the watermarks seed a promoted standby's lease
            # floor). Survives a zero failover via the client's
            # multi-target rotation + breaker-ordered dead marking.
            ts = max(alpha.mvcc.base_ts,
                     max((l.commit_ts for l in alpha.mvcc.layers),
                         default=0))
            zero.heartbeat(alpha.groups.node_id,
                           group=alpha.groups.gid, max_ts=ts,
                           max_uid=alpha.mvcc.max_uid_seen)

        import threading
        # feed Zero's rebalance loop (reference: tablet-size report in
        # the membership heartbeat); failures are metered + escalated
        # by run_heartbeat_loop instead of dying silently at debug
        threading.Thread(target=run_heartbeat_loop, daemon=True,
                         args=("size", 30.0,
                               alpha.report_tablet_sizes, log)).start()
        threading.Thread(target=run_heartbeat_loop, daemon=True,
                         args=("liveness", args.heartbeat,
                               liveness_step, log)).start()
        # peer-health + tablet-cost heartbeat: Zero's
        # tablet-move decisions read this node's breaker table and
        # measured per-tablet cost sums (Alpha.report_health →
        # ZeroService.ReportHealth) so moves prefer healthy,
        # under-loaded peers and never target half-open/dead ones
        threading.Thread(target=run_heartbeat_loop, daemon=True,
                         args=("health", 15.0,
                               alpha.report_health, log)).start()
    # background maintenance: rollup-when-deep + periodic checkpoint +
    # admin-triggered backup/export, paced and budget-bounded
    # (store/maintenance.py; reference: Badger's background rollups,
    # snapshot ticker, and ee backup workers run WHILE serving)
    alpha.attach_maintenance(
        cfg.p_dir, rollup_after=cfg.rollup_after,
        checkpoint_every_s=cfg.checkpoint_every_s,
        pacing_ms=cfg.maintenance_pacing_ms)
    if cfg.rollup_after or cfg.checkpoint_every_s:
        log.info("maintenance armed: rollup_after=%d "
                 "checkpoint_every_s=%.1f pacing_ms=%.1f",
                 cfg.rollup_after, cfg.checkpoint_every_s,
                 cfg.maintenance_pacing_ms)
    # flight recorder (utils/flightrec.py): always-on black box —
    # bounded event ring + the predicted-cost watchdog. A request
    # running stall_factor× past its costprior prediction, a wedged
    # queue head, a stalled maintenance job, or a wedged telemetry
    # pusher writes a self-contained diagnostic bundle to diag_dir
    # with NO operator action; SIGUSR2 and POST /debug/flightrecorder
    # dump on demand
    import dataclasses as _dc

    from dgraph_tpu_torch.utils import flightrec
    diag_dir = cfg.diag_dir or os.path.join(cfg.p_dir, "diag")
    flightrec.arm(
        diag_dir=diag_dir, stall_factor=cfg.stall_factor,
        stall_floor_ms=cfg.stall_floor_ms, alpha=alpha, pusher=pusher,
        signals=True,
        config={f.name: getattr(cfg, f.name)
                for f in _dc.fields(cfg)})
    log.info("flight recorder armed: diag_dir=%s stall_factor=%.1f "
             "stall_floor_ms=%.0f (SIGUSR2 or POST "
             "/debug/flightrecorder dumps a bundle)", diag_dir,
             cfg.stall_factor, cfg.stall_floor_ms)
    if cfg.ts_interval_s > 0:
        # retained metrics history + SLO burn-rate engine + load
        # forecast (utils/timeseries.py, utils/slo.py): the sampler
        # daemon snapshots the registry every tick into the memgov-
        # governed ring, evaluates fast/slow-window burn rates (a
        # breach emits a flight event with an exemplar trace id; a
        # SUSTAINED fast burn convicts via the watchdog as kind=slo),
        # and feeds admission's predicted-load shedding
        from dgraph_tpu_torch.utils import slo, timeseries
        engine = slo.SloEngine(slo.parse_spec(cfg.slo_spec))
        timeseries.arm(interval_s=cfg.ts_interval_s,
                       ring_points=cfg.ts_ring_points,
                       slo_engine=engine,
                       forecast=cfg.forecast_shedding)
        log.info("time-series sampler armed: interval_s=%.1f "
                 "ring_points=%d slos=%s forecast_shedding=%s "
                 "(/debug/timeseries, /debug/slo)",
                 cfg.ts_interval_s, cfg.ts_ring_points,
                 ",".join(sorted(engine.targets)),
                 cfg.forecast_shedding)
    http_server = make_http_server(alpha, cfg.http_addr, cfg.http_port)
    serve_background(http_server)
    log.info("alpha up: grpc=%d http=%d", grpc_port,
             http_server.server_address[1])
    try:
        grpc_server.wait_for_termination()
    except KeyboardInterrupt:
        # first stop taking requests and let those in flight end: a
        # request thread still inside a torch call when the interpreter
        # exits aborts the process, and a write landing after the final
        # checkpoint would be left to the WAL alone
        http_server.shutdown()
        grpc_server.stop(REQUEST_DRAIN_S)
        _drain_requests(log)
        # drain the in-flight maintenance job (a half-written triggered
        # backup must finish), then the final checkpoint
        log.info("shutting down; draining maintenance + checkpointing "
                 "to %s", cfg.p_dir)
        alpha.shutdown(cfg.p_dir)
        if pusher is not None:
            pusher.stop(flush=True)  # best-effort final batch
        if cfg.trace_export:
            # span registry → OTLP/JSON for an external collector
            from dgraph_tpu_torch.utils import tracing
            n = tracing.export_otlp(cfg.trace_export)
            log.info("exported %d spans as OTLP/JSON to %s", n,
                     cfg.trace_export)
        if mesh is not None and mesh.spans_processes:
            from dgraph_tpu_torch.parallel.mesh import shutdown_distributed
            shutdown_distributed()
    return 0


def cmd_zero(args) -> int:
    # Standalone cluster manager (reference: dgraph zero): ts/uid leases,
    # commit arbitration, membership, tablet assignment/rebalance — the
    # full pb.Zero surface (cluster/zero.py). With --w the state machine
    # journals to disk and a restart preserves tablets and watermarks.
    import threading

    from dgraph_tpu_torch.cluster.zero import (ZeroState,
                                               make_zero_server,
                                               rebalance_once)

    xlog.setup(args.log_level)
    log = xlog.get("zero")
    state = ZeroState(
        replicas=args.replicas,
        journal_path=(f"{args.w}/zero.journal" if args.w else None),
        txn_timeout_s=args.txn_timeout,
        liveness_s=args.liveness,
        standby=bool(args.peer))
    server, port, _state = make_zero_server(state,
                                            f"127.0.0.1:{args.port}")
    server.start()
    log.info("zero up: grpc=%d replicas=%d journal=%s role=%s", port,
             args.replicas, args.w or "off",
             "standby" if args.peer else "primary")
    if args.peer:
        # standby: tail the primary's state machine; promote when it
        # stays dark (reference: group-0 follower + failover)
        from dgraph_tpu_torch.cluster.zero import run_standby

        # elections are SAFE BY DEFAULT: with standby peers configured,
        # promotion needs a majority of the electorate reachable
        # (require_quorum=None → auto-on in run_standby); availability
        # mode is an explicit opt-out that run_standby logs loudly
        require_quorum = None
        if args.election_availability:
            require_quorum = False
        elif args.election_quorum:
            require_quorum = True

        def standby_loop():
            peers = [a for a in (args.standby_peers or "").split(",")
                     if a]
            if run_standby(state, args.peer,
                           promote_after_s=args.promote_after,
                           peers=peers, my_addr=f"127.0.0.1:{args.port}",
                           require_quorum=require_quorum):
                log.warning("primary %s unreachable %.1fs — PROMOTED; "
                            "now serving leases", args.peer,
                            args.promote_after)

        threading.Thread(target=standby_loop, daemon=True).start()

    def maintenance():
        import time
        # graftlint: allow(retry-deadline): daemon scheduler — the sleep
        # is the tick cadence, not a backoff; no request budget exists
        while True:
            time.sleep(max(args.txn_timeout / 2, 1.0)
                       if args.txn_timeout else 10.0)
            try:
                n = state.expire_stale_txns()
                if n:
                    log.info("expired %d abandoned txns", n)
                if args.rebalance and rebalance_once(state):
                    log.info("rebalanced one tablet")
            except Exception:  # noqa: BLE001 — the loop must outlive bugs
                log.exception("zero maintenance sweep failed")

    t = threading.Thread(target=maintenance, daemon=True)
    t.start()
    server.wait_for_termination()
    return 0


def cmd_bulk(args) -> int:
    from dgraph_tpu_torch.loader.bulk import run_bulk
    xlog.setup(args.log_level)
    rdf = open(args.files).read()
    schema = open(args.schema).read() if args.schema else ""
    st = run_bulk(rdf, args.out, schema_text=schema,
                  n_mappers=args.mappers)
    print(json.dumps({"nquads": st.nquads, "nodes": st.nodes,
                      "edges": st.edges, "elapsed_s": round(st.elapsed_s, 3)}))
    return 0


def cmd_live(args) -> int:
    _require_device(args.device, "live")
    from dgraph_tpu_torch.loader.live import run_live
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.store import checkpoint
    xlog.setup(args.log_level)
    import os
    base = None
    if os.path.exists(os.path.join(args.p, "manifest.json")):
        base, _ = checkpoint.load(args.p)
    alpha = Alpha(base=base, device=args.device)
    if args.schema:
        alpha.alter(open(args.schema).read())
    st = run_live(alpha, open(args.files).read(),
                  batch_size=args.batch, concurrency=args.conc)
    checkpoint.save(alpha.mvcc.rollup(), args.p, base_ts=alpha.mvcc.base_ts)
    print(json.dumps({"nquads": st.nquads, "txns": st.txns,
                      "aborts": st.aborts,
                      "elapsed_s": round(st.elapsed_s, 3)}))
    return 0


def cmd_backup(args) -> int:
    """Binary backup: full or incremental-since-last (reference:
    ee/backup; SURVEY §2.5). --memory_budget_mb opens the source
    out-of-core so a store larger than RAM backs up streamed.
    `dgraph_tpu_torch backup verify --dest D` walks the whole chain offline
    (manifests, per-file digests, delta record counts, contiguity) and
    exits non-zero on any integrity error."""
    xlog.setup(args.log_level)
    if args.verb == "verify":
        from dgraph_tpu_torch.server.backup import verify_chain
        report = verify_chain(args.dest)
        print(json.dumps(report, indent=1))
        return 0 if report["ok"] else 1
    from dgraph_tpu_torch.server.backup import backup
    m = backup(args.p, args.dest, force_full=args.full,
               memory_budget=(args.memory_budget_mb << 20)
               if args.memory_budget_mb else None)
    print(json.dumps(m))
    return 0


def cmd_restore(args) -> int:
    """Rebuild a posting dir from a backup series (reference: ee
    restore). Crash-safe + resumable: a kill leaves the previous store
    serveable, a re-run resumes from the last verified tablet;
    --memory_budget_mb streams the fold so a chain bigger than RAM
    restores under budget."""
    from dgraph_tpu_torch.server.backup import restore
    xlog.setup(args.log_level)
    ts = restore(args.dest, args.p,
                 memory_budget=(args.memory_budget_mb << 20)
                 if args.memory_budget_mb else None)
    print(json.dumps({"restored_max_ts": ts, "p_dir": args.p}))
    return 0


def cmd_export(args) -> int:
    from dgraph_tpu_torch.server.export import export_json, export_rdf
    from dgraph_tpu_torch.store import checkpoint
    if args.memory_budget_mb:
        # stream the export: tablets fault in one at a time and release
        # (store/stream.py) — a snapshot larger than RAM exports fine
        from dgraph_tpu_torch.store.outofcore import open_out_of_core
        store, _ = open_out_of_core(args.p, args.memory_budget_mb << 20)
    else:
        store, _ = checkpoint.load(args.p)
    with open(args.out, "w") as f:
        n = (export_json if args.format == "json" else export_rdf)(store, f)
    print(json.dumps({"exported": n, "format": args.format}))
    return 0


def _safe_name(addr: str) -> str:
    return "".join(c if c.isalnum() else "-" for c in addr)


def _diagnose_fleet(args) -> int:
    """`dgraph_tpu_torch diagnose --fleet`: one directory of diagnostics for
    the WHOLE cluster — the addressed server's full bundle (the PR-13
    verb), the fleet snapshot, and every known peer's flight-recorder
    snapshot pulled through the server's /debug/fleet/flight proxy
    (the DebugFlight worker RPC), each file named by node."""
    import os
    import urllib.request
    base = f"http://{args.addr}"
    out_dir = args.out or ("fleet-" + _safe_name(args.addr))
    os.makedirs(out_dir, exist_ok=True)
    req = urllib.request.Request(
        base + "/debug/flightrecorder",
        data=json.dumps({"action": "dump"}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    if args.token:
        req.add_header("X-Dgraph-AccessToken", args.token)
    # graftlint: allow(direct-io): operator CLI pulling diagnostics
    # over a server's HTTP surface — not a cluster RPC; no breaker/
    # retry/budget layer applies to a one-shot diagnostic pull
    with urllib.request.urlopen(req, timeout=args.timeout) as r:
        bundle = json.loads(r.read())["data"]["bundle"]
    with open(os.path.join(out_dir, "local.json"), "w") as f:
        json.dump(bundle, f)
    # graftlint: allow(direct-io): same one-shot operator pull
    with urllib.request.urlopen(base + "/debug/fleet",
                                timeout=args.timeout) as r:
        fleet_doc = json.loads(r.read())
    with open(os.path.join(out_dir, "fleet.json"), "w") as f:
        json.dump(fleet_doc, f)
    nodes = sorted(fleet_doc.get("nodes", {}))
    written, errors = ["local.json", "fleet.json"], dict(
        fleet_doc.get("errors", {}))
    for node in nodes:
        if node == fleet_doc.get("self"):
            continue  # the local bundle already covers this node
        try:
            # graftlint: allow(direct-io): same one-shot operator pull
            with urllib.request.urlopen(
                    base + "/debug/fleet/flight?peer=" + node,
                    timeout=args.timeout) as r:
                doc = json.loads(r.read())
            name = _safe_name(node) + ".json"
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(doc, f)
            written.append(name)
        except Exception as e:  # noqa: BLE001 — a dark peer degrades the pull
            errors[node] = f"{type(e).__name__}: {e}"
    print(json.dumps({"dir": out_dir, "nodes": nodes,
                      "written": written, "errors": errors}))
    return 0 if not errors else 1


def cmd_diagnose(args) -> int:
    """Pull a one-shot diagnostic bundle from a LIVE server: POST
    /debug/flightrecorder {"action": "dump"} makes the server build
    (and, when armed with a diag dir, also persist) the full bundle —
    all-thread stacks, the flight ring, every debug surface, metrics,
    config — and return it inline; this verb writes it to --out.
    `--fleet` widens the pull to every known cluster node (one
    directory, one file per node)."""
    import urllib.request
    xlog.setup(args.log_level)
    if args.fleet:
        return _diagnose_fleet(args)
    url = f"http://{args.addr}/debug/flightrecorder"
    req = urllib.request.Request(
        url, data=json.dumps({"action": "dump"}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    if args.token:
        req.add_header("X-Dgraph-AccessToken", args.token)
    # graftlint: allow(direct-io): operator CLI pulling a debug bundle
    # over a server's HTTP surface — not a cluster RPC; no breaker/
    # retry/budget layer applies to a one-shot diagnostic pull
    with urllib.request.urlopen(req, timeout=args.timeout) as r:
        doc = json.loads(r.read())
    bundle = doc["data"]["bundle"]
    out = args.out or ("flight-"
                       + "".join(c if c.isalnum() else "-"
                                 for c in args.addr) + ".json")
    with open(out, "w") as f:
        json.dump(bundle, f)
    print(json.dumps({
        "path": out,
        "server_path": doc["data"].get("path"),
        "trigger": bundle.get("trigger"),
        "inflight": len(bundle.get("inflight", [])),
        "surfaces": sorted(bundle.get("surfaces", {}))}))
    return 0


def cmd_fleet(args) -> int:
    """One cluster-wide observability snapshot from a live server:
    GET /debug/fleet fans out over every known node (breaker-aware,
    budget-bounded, partial on dark peers), merges the cost digests
    exactly, and instance-labels the metrics. Prints a summary;
    --out writes the full document."""
    import urllib.request
    xlog.setup(args.log_level)
    url = f"http://{args.addr}/debug/fleet"
    if args.budget_ms:
        url += f"?budget_ms={args.budget_ms:g}"
    # graftlint: allow(direct-io): operator CLI pulling a debug
    # snapshot over a server's HTTP surface — not a cluster RPC; no
    # breaker/retry/budget layer applies to a one-shot pull
    with urllib.request.urlopen(url, timeout=args.timeout) as r:
        doc = json.loads(r.read())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f)
    nodes = doc.get("nodes", {})
    print(json.dumps({
        "self": doc.get("self"),
        "nodes": {a: {"group": n.get("group"),
                      "spans": n.get("spans"),
                      "watchdog_armed":
                          n.get("watchdog", {}).get("armed", False),
                      "gates": n.get("gates")}
                  for a, n in sorted(nodes.items())},
        "errors": doc.get("errors", {}),
        "cost_records_total":
            doc.get("costs", {}).get("records_total"),
        "out": args.out}, indent=1))
    return 0


def cmd_debug(args) -> int:
    """Snapshot inspector (reference: dgraph debug p-dir dump)."""
    from dgraph_tpu_torch.store import checkpoint
    store, base_ts = checkpoint.load(args.p)
    info = {
        "base_ts": base_ts,
        "nodes": store.n_nodes,
        "predicates": {
            p: {"edges": pd.fwd.nnz if pd.fwd else 0,
                "reverse": pd.rev is not None,
                "value_rows": {lang or ".": len(col.subj)
                               for lang, col in pd.vals.items()},
                "indexes": sorted(pd.index)}
            for p, pd in sorted(store.preds.items())},
        "schema": store.schema.to_text(),
    }
    print(json.dumps(info, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dgraph_tpu_torch",
        description="distributed graph database on NVIDIA Hopper "
                    "(PyTorch and CUDA)")
    ap.add_argument("--version", action="version",
                    version=f"dgraph_tpu_torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    # at-rest encryption flags, shared by every subcommand that touches
    # a posting dir, WAL, or backup series (argparse parent parser)
    enc = argparse.ArgumentParser(add_help=False)
    enc.add_argument("--encryption_key_file", default=None,
                     help="AES key file (16/24/32 bytes) → encrypt "
                          "checkpoints, WAL, and backups at rest")
    enc.add_argument("--encryption_strict", action="store_true",
                     help="reject plaintext at-rest files (post-"
                          "migration posture: unauthenticated data "
                          "cannot be read)")

    p = sub.add_parser("alpha", help="run the data server", parents=[enc])
    p.add_argument("--p", default=None,
                   help="posting snapshot dir (default: p)")
    p.add_argument("--config", default=None)
    p.add_argument("--http_port", type=int, default=None)
    p.add_argument("--grpc_port", type=int, default=None)
    p.add_argument("--store", default=None,
                   help="grouped engine knobs, 'k=v; k=v' (superflag): "
                        "device_threshold, rollup_every, mesh_devices, …")
    p.add_argument("--device", default=None,
                   help="where reads run: cuda (the default) or cpu; "
                        "without a card, cuda exits non-zero")
    p.add_argument("--mesh-devices", type=int, default=None,
                   dest="mesh_devices",
                   help="SPMD engine over N devices (-1 = all cards, "
                        "0 = off; with --device cpu, N CPU shards)")
    p.add_argument("--acl_secret_file", default=None,
                   help="enable ACL; file holds the token-signing secret")
    p.add_argument("--jax-coordinator", default=None,
                   dest="jax_coordinator",
                   help="host:port of a mesh across processes' "
                        "coordinator (with --mesh-devices; rank and world "
                        "size from JAX_PROCESS_ID / JAX_NUM_PROCESSES)")
    p.add_argument("--zero", default=None,
                   help="zero address(es) → join a cluster; a comma-"
                        "separated list fails over (primary,standby)")
    p.add_argument("--heartbeat", type=float, default=3.0,
                   help="seconds between zero liveness heartbeats")
    p.add_argument("--group", type=int, default=0,
                   help="raft-group analog to join (0 = zero picks)")
    p.add_argument("--memory_budget_mb", type=int, default=None,
                   help="out-of-core mode: fault predicate tablets from "
                        "the checkpoint on demand, LRU-evict above this "
                        "many MB resident (0 = fully resident)")
    p.add_argument("--device_budget_mb", type=int, default=None,
                   help="memory governor: HBM cache budget in MB — "
                        "device relations, shard stacks, and compiled "
                        "kernels evict above 90%% of it down to 70%%, "
                        "lowest recompute-value/byte first; governed "
                        "launches absorb allocation failures with one "
                        "evict-retry then sticky-degrade the shape "
                        "(0 = unguarded)")
    p.add_argument("--host_cache_budget_mb", type=int, default=None,
                   help="memory governor: host-RAM cache budget in MB "
                        "(fused programs, ELL plans, tablet adapters, "
                        "out-of-core residency); same watermark/"
                        "eviction policy as --device_budget_mb "
                        "(0 = unguarded)")
    p.add_argument("--rollup_after", type=int, default=None,
                   help="background-fold when this many delta layers "
                        "are pending (0 = off); out-of-core stores "
                        "stream the fold tablet-at-a-time")
    p.add_argument("--checkpoint_every_s", type=float, default=None,
                   help="periodic background checkpoint + WAL truncate "
                        "every this many seconds (0 = off)")
    p.add_argument("--maintenance_pacing_ms", type=float, default=None,
                   help="sleep between tablets of a maintenance job so "
                        "serving keeps the disk/CPU (0 = no pacing)")
    p.add_argument("--slow_query_ms", type=int, default=None,
                   help="log queries slower than this many ms with "
                        "their trace id (0 = off); spans stay "
                        "retrievable at /debug/traces?trace_id=")
    p.add_argument("--trace_dir", default=None,
                   help="arm torch.profiler device-trace capture "
                        "(Chrome trace) for device-fenced spans")
    p.add_argument("--trace_export", default=None,
                   help="on shutdown, write the span registry as "
                        "OTLP/JSON to this path (collector-ready)")
    p.add_argument("--telemetry_push_url", default=None,
                   help="stream spans (OTLP /v1/traces) + query cost "
                        "records (/v1/costs) to this collector base "
                        "URL while serving; unset = export stays "
                        "shutdown/pull-shaped")
    p.add_argument("--telemetry_push_interval_s", type=float,
                   default=None,
                   help="flush cadence of the live telemetry pusher "
                        "(bounded buffer; drops are counted in "
                        "telemetry_dropped_total, never block serving)")
    p.add_argument("--diag_dir", default=None,
                   help="flight-recorder bundle dir (default: "
                        "<p_dir>/diag); the watchdog, SIGUSR2, and "
                        "POST /debug/flightrecorder write one-shot "
                        "diagnostic bundles here")
    p.add_argument("--stall_factor", type=float, default=None,
                   help="watchdog convicts an unbounded request at "
                        "this multiple of its costprior-predicted "
                        "cost (fallback: lane EMA, then "
                        "--stall_floor_ms); deadline-carrying "
                        "requests are judged against their budget")
    p.add_argument("--stall_floor_ms", type=float, default=None,
                   help="prediction fallback AND the floor a stall "
                        "conviction threshold never drops below")
    p.add_argument("--max_inflight", type=int, default=None,
                   help="admission control: concurrent requests per "
                        "lane (read/mutate); 0 = unbounded (off)")
    p.add_argument("--queue_depth", type=int, default=None,
                   help="bounded FIFO wait queue per lane; a full "
                        "queue sheds with retryable 429/ServerOverloaded")
    p.add_argument("--default_deadline_ms", type=float, default=None,
                   help="budget for requests that carry no ?timeout=/"
                        "X-Deadline-Ms of their own (0 = unbounded)")
    p.add_argument("--cost_priors", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="per-shape cost priors drive admission "
                        "shedding/Retry-After, batch-plan ordering, "
                        "and the placement heartbeat (default on; "
                        "--no-cost_priors restores count/EMA-only "
                        "scheduling)")
    p.add_argument("--ts_interval_s", type=float, default=None,
                   help="metrics-history sampler cadence in seconds: "
                        "each tick snapshots the registry into the "
                        "retained ring (counters as rates, histograms "
                        "as windowed p50/p90/p99) and evaluates SLO "
                        "burn rates (0 = sampler off)")
    p.add_argument("--ts_ring_points", type=int, default=None,
                   help="retained-history ring capacity in points "
                        "(default 3600 ≈ 1h at 1s); the ring is "
                        "memgov-governed — memory pressure surrenders "
                        "the oldest history first")
    p.add_argument("--slo_spec", default=None,
                   help="SLO target overrides, 'name=value; ...' "
                        "superflag over utils/slo.SLO_SPECS (e.g. "
                        "'read_latency_p99_us=50000; "
                        "error_rate=0.001'); unnamed objectives keep "
                        "their defaults")
    p.add_argument("--forecast_shedding", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="Holt-trend load forecast (arrival rate × "
                        "predicted cost) sheds admissions BEFORE the "
                        "queue fills when predicted demand exceeds "
                        "capacity (default on; --no-forecast_shedding "
                        "keeps admission purely reactive, "
                        "bit-identical to the pre-forecast path)")
    p.add_argument("--rpc_retries", type=int, default=None,
                   help="re-attempts per retryable cluster RPC "
                        "(UNAVAILABLE/connect failures only; backoff "
                        "jittered + capped by the request budget)")
    p.add_argument("--breaker_threshold", type=int, default=None,
                   help="consecutive transport failures that open a "
                        "peer's circuit breaker (then calls fail fast "
                        "until a half-open probe succeeds)")
    p.add_argument("--breaker_cooldown_ms", type=float, default=None,
                   help="open-breaker cool-down before the single "
                        "half-open probe (jittered; doubles per "
                        "re-open, capped)")
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_alpha)

    p = sub.add_parser("zero", help="run the cluster manager service", parents=[enc])
    p.add_argument("--port", type=int, default=5080)
    p.add_argument("--replicas", type=int, default=1,
                   help="replicas per group (elasticity knob)")
    p.add_argument("--w", default=None,
                   help="journal dir (state survives restart)")
    p.add_argument("--txn_timeout", type=float, default=300.0,
                   help="abort pending txns older than this — the max "
                        "transaction lifetime (0 = never)")
    p.add_argument("--rebalance", action="store_true",
                   help="enable the size-based tablet rebalance loop")
    p.add_argument("--peer", default=None,
                   help="primary zero address → run as a STANDBY that "
                        "tails its journal and promotes on failure")
    p.add_argument("--promote_after", type=float, default=5.0,
                   help="standby promotes after the primary is dark "
                        "this long")
    p.add_argument("--standby_peers", default="",
                   help="comma-separated OTHER standby addresses: on "
                        "primary failure the most caught-up standby "
                        "wins the election (highest applied journal "
                        "index), the rest re-target it")
    p.add_argument("--election_quorum", action="store_true",
                   help="require a majority of the standby electorate "
                        "reachable before promoting. This is already "
                        "the DEFAULT whenever --standby_peers is set; "
                        "the flag remains for explicitness")
    p.add_argument("--election_availability", action="store_true",
                   help="OPT OUT of quorum elections: a standby cut "
                        "off from the whole electorate still promotes "
                        "(raft's availability trade — a symmetric "
                        "partition can dual-promote; logged loudly)")
    p.add_argument("--liveness", type=float, default=10.0,
                   help="mark an alpha dead after this many seconds "
                        "without a heartbeat (0 = off)")
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_zero)

    p = sub.add_parser("bulk", help="offline bulk load → snapshot dir", parents=[enc])
    p.add_argument("--files", required=True, help="N-Quad input file")
    p.add_argument("--schema", default=None)
    p.add_argument("--out", default="p")
    p.add_argument("--mappers", type=int, default=4)
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_bulk)

    p = sub.add_parser("live", help="transactional load into a snapshot", parents=[enc])
    p.add_argument("--files", required=True)
    p.add_argument("--schema", default=None)
    p.add_argument("--p", default="p")
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--conc", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="where the loading Alpha runs: cuda (the "
                        "default) or cpu; without a card, cuda exits "
                        "non-zero")
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("backup", help="binary backup (full/incremental)", parents=[enc])
    p.add_argument("verb", nargs="?", choices=["verify"], default=None,
                   help="'verify' walks the chain at --dest offline: "
                        "manifests, per-file digests, delta record "
                        "counts, contiguity; exit 1 on any error")
    p.add_argument("--p", default="p", help="posting dir to back up")
    p.add_argument("--dest", required=True, help="backup series dir")
    p.add_argument("--full", action="store_true",
                   help="force a full backup even if the chain extends")
    p.add_argument("--memory_budget_mb", type=int, default=0,
                   help="open the source out-of-core and stream the "
                        "full backup tablet-at-a-time under this "
                        "budget (0 = fully resident)")
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_backup)

    p = sub.add_parser("restore", help="rebuild a posting dir from backups", parents=[enc])
    p.add_argument("--dest", required=True, help="backup series dir")
    p.add_argument("--p", required=True, help="posting dir to write")
    p.add_argument("--memory_budget_mb", type=int, default=0,
                   help="stream the restore fold tablet-at-a-time "
                        "under this budget — a backup chain bigger "
                        "than RAM restores without materializing "
                        "(0 = fully resident)")
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_restore)

    p = sub.add_parser("export", help="dump a snapshot as RDF/JSON", parents=[enc])
    p.add_argument("--p", default="p")
    p.add_argument("--out", required=True)
    p.add_argument("--format", choices=("rdf", "json"), default="rdf")
    p.add_argument("--memory_budget_mb", type=int, default=0,
                   help="stream the export out-of-core under this "
                        "budget (0 = fully resident)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("debug", help="inspect a snapshot dir", parents=[enc])
    p.add_argument("--p", default="p")
    p.set_defaults(fn=cmd_debug)

    p = sub.add_parser("diagnose",
                       help="pull a one-shot diagnostic bundle from a "
                            "live server's flight recorder")
    p.add_argument("addr", help="host:port of the alpha's HTTP surface")
    p.add_argument("--out", default=None,
                   help="bundle output path (default: "
                        "flight-<addr>.json); with --fleet, the "
                        "output DIRECTORY (default: fleet-<addr>/)")
    p.add_argument("--fleet", action="store_true",
                   help="pull diagnostics from EVERY known cluster "
                        "node into one directory, named by node: the "
                        "addressed server's full bundle plus each "
                        "peer's flight snapshot over the DebugFlight "
                        "RPC")
    p.add_argument("--token", default=None,
                   help="ACL access token, when the server enforces "
                        "ACL (the endpoint shares the Alter bar)")
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_diagnose)

    p = sub.add_parser("fleet",
                       help="one cluster-wide observability snapshot "
                            "(GET /debug/fleet) from a live server")
    p.add_argument("addr", help="host:port of any alpha's HTTP surface")
    p.add_argument("--out", default=None,
                   help="write the full fleet document here (the "
                        "summary always prints)")
    p.add_argument("--budget_ms", type=float, default=0.0,
                   help="overall fan-out budget (0 = server default); "
                        "peers past it degrade to an errors entry")
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--log_level", default="info")
    p.set_defaults(fn=cmd_fleet)

    args = ap.parse_args(argv)
    if getattr(args, "encryption_key_file", None):
        # every subcommand that touches a posting dir, WAL, or backup
        # series honors the same at-rest key (reference: the encryption
        # superflag is process-wide)
        from dgraph_tpu_torch.store import vault
        vault.load_key_file(args.encryption_key_file,
                            strict=getattr(args, "encryption_strict",
                                           False))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
