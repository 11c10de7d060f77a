"""Port of `dgraph_tpu/cluster`: Zero, groups, the resilience layer,
routed reads and tablet shipping, and the oracle.

`start_cluster_alpha` boots one node of a cluster: a gRPC server, its
Zero connection and its `Groups`. Its reads run on `device`, the card
unless the caller names "cpu" (`server/api.py`); Zero holds no tensors
and takes no device (`cluster/zero.make_zero_server`).
"""

from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE


def start_cluster_alpha(zero_target: str, base=None, group: int = 0,
                        device_threshold: int = 512,
                        addr: str = "127.0.0.1:0",
                        wal_dir: str | None = None,
                        breaker_threshold: int = 5,
                        breaker_cooldown_ms: float = 500.0,
                        rpc_retries: int = 2,
                        device=DEFAULT_DEVICE):
    """Boot one cluster-mode Alpha: grpc server + Zero connect + Groups.

    Returns (alpha, grpc_server, bound_addr). Reference: alpha run() —
    serve pb.Worker, Connect to Zero for node id + group assignment, then
    keep membership fresh. `wal_dir` arms the fsync'd WAL — required for
    commit-quorum staging to be durable (reference: the raft WAL under
    every Alpha). The breaker/retry knobs parameterize the node's
    resilience layer (cluster/resilience.py). Raises without a card
    unless `device` is "cpu", before it connects to anything."""
    from dgraph_tpu_torch.cluster.groups import Groups
    from dgraph_tpu_torch.cluster.zero import RemoteOracle, ZeroClient
    from dgraph_tpu_torch.server.api import Alpha
    from dgraph_tpu_torch.server.task import make_server
    from dgraph_tpu_torch.utils.device import resolve_device

    resolve_device(device)
    zero = ZeroClient(zero_target)
    alpha = Alpha(base=base, device_threshold=device_threshold,
                  oracle=RemoteOracle(zero), device=device)
    max_ts, max_uid = alpha.mvcc.base_ts, 0
    if wal_dir is not None:
        import os

        # replay + re-arm before serving: a restarted replica's stage
        # acks certified durable records that MUST be visible again
        # (Alpha.open's boot leg, shared via attach_wal)
        wal_ts, wal_uid = alpha.attach_wal(
            os.path.join(wal_dir, "wal.log"))
        max_ts = max(max_ts, wal_ts)
        max_uid = max(max_uid, wal_uid)
    server, port = make_server(alpha, addr)
    server.start()
    bound = f"127.0.0.1:{port}"
    if base is not None and base.n_nodes:
        max_uid = max(max_uid, int(base.uids[-1]))
    alpha.groups = Groups(zero, bound, group=group, max_ts=max_ts,
                          max_uid=max_uid,
                          breaker_threshold=breaker_threshold,
                          breaker_cooldown_ms=breaker_cooldown_ms,
                          rpc_retries=rpc_retries)
    return alpha, server, bound
