"""Typed configuration + superflag parsing.

Port of `dgraph_tpu/utils/config.py`, with one field of its own:
`AlphaConfig.device`, where the Alpha reads (default the card; "cpu"
only when asked). `mesh_devices` is served over this process's devices,
or, under `--jax-coordinator`, over the first N of every process's
(`cli.py`).
Reference parity: `x/flags.go` (`z.SuperFlag` grouped flags like
`--badger compression=zstd;numgoroutines=8`) and the cobra/viper flag
surface of `dgraph alpha|zero` (SURVEY §5 config system). One dataclass
per process role; values come from defaults < config file (JSON/TOML-lite)
< CLI flags.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field


def parse_superflag(s: str) -> dict[str, str]:
    """'a=1; b=x' → {'a': '1', 'b': 'x'} (reference: z.SuperFlag)."""
    out = {}
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"superflag needs key=value, got {part!r}")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out


@dataclass
class AlphaConfig:
    """`dgraph_tpu_torch alpha` (reference: dgraph/cmd/alpha/run.go
    flags)."""

    p_dir: str = "p"              # posting checkpoint dir
    http_addr: str = "127.0.0.1"
    http_port: int = 8080
    grpc_port: int = 9080
    device: str = "cuda"          # where reads run: "cuda" or "cpu"
    device_threshold: int = 512   # frontier size that moves a hop on-device
    mesh_devices: int = 0         # 0 = no mesh; -1 = all devices; N = N
    rollup_every: int = 64        # commits between automatic rollups
    memory_budget_mb: int = 0     # 0 = fully resident; >0 = out-of-core
                                  # tablet faulting under this budget
    # unified cache governor (utils/memgov.py): 0 disarms a kind;
    # armed, every byte-holding cache (fused programs, ELL plans,
    # device relations, tablets, LazyPreds residency) evicts above
    # 90% of the budget down to 70%, lowest recompute-value/byte first
    device_budget_mb: int = 0     # HBM-resident cache budget
    host_cache_budget_mb: int = 0  # host-RAM cache budget
    # background maintenance scheduler (store/maintenance.py):
    rollup_after: int = 0         # fold when this many delta layers are
                                  # pending (0 = no background rollup)
    checkpoint_every_s: float = 0.0  # periodic checkpoint+WAL-truncate
                                     # period in seconds (0 = off)
    maintenance_pacing_ms: float = 0.0  # sleep between tablets of a
                                        # maintenance job (serving gets
                                        # the disk/CPU back in between)
    # admission control + request lifecycle (server/admission.py,
    # utils/deadline.py):
    max_inflight: int = 0         # per-lane concurrent-request tokens
                                  # (0 = admission control off)
    queue_depth: int = 16         # bounded FIFO wait queue per lane;
                                  # full queue sheds (ServerOverloaded)
    default_deadline_ms: float = 0.0  # budget for requests that bring
                                      # none (0 = unbounded)
    cost_priors: bool = True      # per-shape cost priors drive admission
                                  # shedding/hints, batch-plan ordering,
                                  # and the placement heartbeat
                                  # (utils/costprior.py); False restores
                                  # count/EMA-only scheduling
    # peer-failure resilience (cluster/resilience.py):
    rpc_retries: int = 2          # re-attempts per retryable cluster RPC
                                  # (transport failures only; backoff is
                                  # capped by the request budget)
    breaker_threshold: int = 5    # consecutive transport failures that
                                  # open a peer's circuit breaker
    breaker_cooldown_ms: float = 500.0  # open-breaker cool-down before
                                        # the half-open probe (jittered,
                                        # doubling per re-open)
    trace_export: str = ""        # write the span registry as
                                  # OTLP/JSON here on shutdown
    # flight recorder + watchdog (utils/flightrec.py): always-on black
    # box; diagnostic bundles land in diag_dir ("" = <p_dir>/diag)
    diag_dir: str = ""
    stall_factor: float = 10.0    # convict a request at factor × its
                                  # costprior prediction (fallback:
                                  # lane EMA, then stall_floor_ms)
    stall_floor_ms: float = 500.0  # prediction fallback + the floor a
                                   # conviction threshold never drops
                                   # below
    # live telemetry push (utils/push.py): stream spans + cost records
    # to an OTLP collector while serving (unset = graceful no-op)
    telemetry_push_url: str = ""      # collector base URL (…/v1/traces)
    telemetry_push_interval_s: float = 5.0  # batch flush cadence
    encryption_key_file: str = ""  # at-rest AES key (reference: ee enc)
    encryption_strict: bool = False  # reject plaintext files once migrated
    slow_query_ms: int = 0        # log queries slower than this (0 = off)
    # time-series telemetry + SLO engine (utils/timeseries.py,
    # utils/slo.py): retained metrics history sampled from the shared
    # registry, multi-window burn-rate alerting, and the load forecast
    # that feeds admission's predicted-load shedding
    ts_interval_s: float = 1.0    # sampler cadence (0 = sampler off)
    ts_ring_points: int = 3600    # retained samples (memgov-governed)
    slo_spec: str = ""            # superflag overrides of the default
                                  # SLO budgets, e.g.
                                  # "read_latency_p99_us=5000;
                                  #  error_rate=0.01"
    forecast_shedding: bool = True  # trend forecast (arrival rate ×
                                    # predicted cost) sheds ahead of the
                                    # queue filling; False restores the
                                    # reactive-only admission path
    trace_dir: str = ""           # arm torch.profiler device-trace capture
    log_level: str = "info"


@dataclass
class ZeroConfig:
    """`dgraph_tpu_torch zero` (reference: dgraph/cmd/zero/run.go
    flags)."""

    grpc_port: int = 5080
    first_uid: int = 1
    first_ts: int = 1
    log_level: str = "info"


def load_config(cls, path: str | None = None, overrides: dict | None = None):
    """defaults < json file < overrides (reference: viper precedence)."""
    cfg = cls()
    if path and os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        for k, v in data.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
    for k, v in (overrides or {}).items():
        if v is not None and hasattr(cfg, k):
            fieldtype = type(getattr(cfg, k))
            if fieldtype is bool and isinstance(v, str):
                # bool("false") is True — parse by word, and REJECT
                # unrecognized input (a typo must not silently disable
                # a security knob; reference: strconv.ParseBool errors)
                low = v.strip().lower()
                if low in ("1", "true", "yes", "on"):
                    v = True
                elif low in ("0", "false", "no", "off"):
                    v = False
                else:
                    raise ValueError(
                        f"invalid boolean {v!r} for config key {k!r}")
            setattr(cfg, k, fieldtype(v))
    return cfg
