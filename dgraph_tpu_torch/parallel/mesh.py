"""The device mesh, its placements and its collectives, in one process or
across several.

Port of `dgraph_tpu/parallel/mesh.py`. The reference's topology is a
`jax.sharding.Mesh` with one named axis, "shard", over which posting-store
rows are partitioned and across which the hop programs' collectives run.
Here a `Mesh` is an ordered tuple of `torch.device`s on that one axis,
each shard owned by one process (`Mesh.ranks`).

In one process, `make_mesh(n)` takes the first n cards; an explicit
`devices` list may name one card more than once, which is how one card
holds several shards (the card's counterpart of the reference tests'
`--xla_force_host_platform_device_count`); `device="cpu"` gives n shards
on the CPU, the tests' mesh.

Across processes, `init_distributed` joins a `torch.distributed` process
group (the reference's `jax.distributed`): from explicit arguments, the
reference's env trio `JAX_COORDINATOR_ADDRESS` / `JAX_NUM_PROCESSES` /
`JAX_PROCESS_ID`, or, with `JAX_DIST_AUTO=1`, torchrun's `RANK` /
`WORLD_SIZE` / `MASTER_ADDR` / `MASTER_PORT`. The group has an explicit
timeout (`DIST_TIMEOUT_S`, or DGRAPH_TPU_DIST_TIMEOUT_S): a rank that
never arrives, or a collective one rank skips, raises within it instead
of hanging.
Then `make_mesh` builds the GLOBAL mesh: every rank's local devices, in
rank order and then local order (the order of the reference's
`jax.devices()`), agreed by one exchange of the ranks' device lists. A
process offers DGRAPH_TPU_LOCAL_SHARDS shards (default 1) of the CPU or
of its card: the one its device names (`cuda:1`), else for a bare
"cuda" card `LOCAL_RANK`, else its rank modulo the cards it sees.
An explicit `devices` list still builds a mesh of this process's own
devices only.

The backend follows the layout of ranks on cards: NCCL when every rank's
shards sit on cards no other rank uses, gloo otherwise (the CPU, and
several processes sharing one card, which NCCL refuses as a duplicate
GPU). Gloo stages a card's operands through the host. The mesh says which
it uses (`Mesh.backend`: None for a mesh of one process).

Values on a mesh come in two forms, the reference's two PartitionSpecs:

* `Sharded(parts)` (`P("shard")`): shard d's own slice, `parts[d]` on
  `mesh.devices[d]`;
* `Replicated(parts)` (`P()`): the same value held by every shard. Shards
  that share a device share ONE tensor (`parts[d] is parts[e]`): four
  shards of one card hold one copy of a replicated frontier, not four.

A process holds only its own shards' parts: another process's are None.
`np.asarray` / `int` of a value not fully held here raises, as
`np.asarray` of a non-fully-addressable `jax.Array` does; `host_np`
gathers it. A replicated value reads its local copy with no transfer.

Shards are a Python list, not one stacked `[D, ...]` tensor, so shards
on distinct cards, on one card and in other processes run the same code.
The reference's `shard_map` programs become plain functions: each program
(`dhop.py`, `dsort.py`, `dbfs.py`, `store/vec.py`, `engine/feat.py`) runs
its per-shard body once per shard of this process (`Mesh.local`), one
shard after another, on the current stream of the shard's device, and
splits at each collective.

The collectives live here and nowhere else (graftlint R7): `all_gather`,
`psum`, `pmax`, `ppermute` and `psum_scatter` over a list of per-shard
tensors. Each result is computed once per distinct local device. In one
process they are device ops (stack, sum, max, a rotation of the list);
across distinct cards each operand is copied device to device
(`Tensor.to`). When the mesh spans processes, every shard's operand is
first brought here by one `torch.distributed.all_gather` (`_exchange`),
and the result is then computed exactly as in one process: a sum or a
maximum folds in shard order, never through a backend's all-reduce,
whose order is unspecified, so float sums are bit-equal to the
single-process mesh's and int8 lane sums keep their dtype. Every
operand of one collective has the same shape and dtype on every shard
(the programs' caps make it so).

Every rank must call every collective in the same order (SPMD, as in
the reference). What keeps the ranks in step:

* each rank holds the same store and receives the same requests;
  nothing sheds a request on one rank only: an Alpha over such a mesh
  refuses admission control (`Alpha.attach_admission`, the CLI's
  `--max_inflight`), and with it the forecast shedding that acts
  through it;
* overflow re-runs decide on replicated values (a program's `needs`,
  merged by `pmax`), identical on every rank;
* the route choices that lead to a mesh program decide on sizes and
  thresholds only: the cost priors' learned promotions (local
  timings) are not consulted while a mesh spans processes, nor is a
  shape's prior when `query_batch` forms its lane-kernel groups (the
  count rule alone decides which queries go to the mesh);
* placement (`Store.sharded_rel`, `Store.vec_sharded`, the sort-key
  columns) makes no collective, so one rank's eviction and re-placement
  cannot put the ranks out of step;
* an allocation failure inside a mesh program is not retried while the
  mesh spans processes (`memgov.oom_retry(..., retry=False)`): it
  raises, and the other ranks raise at the group's timeout.

A query's deadline acts per rank: one that expires on one rank only
makes the others raise at the group's timeout. Nothing falls back to a
single-process mesh or to the host.

The steady serving contract is the reference's: a hop's outputs are the
next hop's inputs with their placement already right, so a chained
frontier crosses no device boundary between launches. `hop_input` is the
guard at every hop entry and counts `mesh_hop_resharded_total` when a
local part of a sharded input is not on its shard's device, or a
replicated input lies off a local shard's device; a host numpy seed is
an upload, not a reshard. `reshard_guard` raises when the count moved
inside its block.

`CROSS_CALLS` counts this process's cross-process calls by kind; a mesh
whose shards are all local makes none, even inside a process group (the
reference's `is_fully_addressable` rule).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from dgraph_tpu_torch.utils.device import resolve_device
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["SHARD_AXIS", "REPLICATED", "SHARDED", "Mesh", "Sharded",
           "Replicated", "Placement", "make_mesh", "init_distributed",
           "shutdown_distributed", "process_index", "process_count",
           "host_np", "shard_leading", "replicated", "device_put",
           "replicate", "shard", "gather_shards", "all_gather", "psum",
           "pmax", "ppermute", "psum_scatter", "hop_input", "reshard_count",
           "reshard_guard",
           "PROGRAM_CALLS", "count_program", "CROSS_CALLS",
           "DIST_TIMEOUT_S", "LOCAL_SHARDS_ENV"]

SHARD_AXIS = "shard"
# the reference's PartitionSpecs: P() and P("shard")
REPLICATED: tuple = ()
SHARDED: tuple = (SHARD_AXIS,)

# how long a rendezvous or a collective waits for every rank before it
# raises (override per process with DGRAPH_TPU_DIST_TIMEOUT_S)
DIST_TIMEOUT_S = 300.0
# shards each process offers of each of its devices in a global mesh
LOCAL_SHARDS_ENV = "DGRAPH_TPU_LOCAL_SHARDS"

# mesh programs run, by name (each program counts one per call, whatever
# the shards and ops inside it); chip_smoke.py zeroes it before a main
# path and reads it after
PROGRAM_CALLS: dict[str, int] = {}

# this process's cross-process calls, by kind (a collective's name,
# "host_np", "nnz" for assemble_sharded_rel's agreement, "mesh_shape")
CROSS_CALLS: dict[str, int] = {}


def count_program(name: str) -> None:
    PROGRAM_CALLS[name] = PROGRAM_CALLS.get(name, 0) + 1


def _count_cross(kind: str) -> None:
    CROSS_CALLS[kind] = CROSS_CALLS.get(kind, 0) + 1


class Mesh:
    """An ordered tuple of devices on the one axis `SHARD_AXIS`. A
    device may repeat: then several shards share it. `ranks[d]` is the
    process that owns shard d; this process (`rank`) holds the shards
    in `local`, and reaches the others through `group` over `backend`
    (both None when every shard is local)."""

    def __init__(self, devices, ranks=None, rank: int = 0, group=None,
                 backend: str | None = None):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in devs}
        if len(types) != 1:
            raise ValueError(f"a mesh spans one device type, got "
                             f"{sorted(types)}")
        self.devices = devs
        self.ranks = tuple(ranks) if ranks is not None else \
            (rank,) * len(devs)
        self.rank = rank
        self.local = tuple(d for d, r in enumerate(self.ranks) if r == rank)
        self.group = group
        self.backend = backend
        # the ranks that own shards, in rank order; per shard its slot
        # among its owner's shards; the most shards any rank owns (what
        # a cross-process gather pads each rank's operands to)
        self.owners = tuple(sorted(set(self.ranks)))
        self._slot = []
        seen: dict = {}
        for r in self.ranks:
            self._slot.append(seen.get(r, 0))
            seen[r] = seen.get(r, 0) + 1
        self._width = max(seen.values())

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def spans_processes(self) -> bool:
        """Whether some shard belongs to another process."""
        return len(self.local) < len(self.devices)

    @property
    def lead(self) -> int:
        """The first shard of this process (where a merged value that
        every local shard holds is read)."""
        if not self.local:
            raise RuntimeError(f"process {self.rank} holds no shard of "
                               f"this mesh")
        return self.local[0]

    def is_local(self, d: int) -> bool:
        return self.ranks[d] == self.rank

    def __repr__(self) -> str:
        if not self.spans_processes:
            return f"Mesh({', '.join(str(d) for d in self.devices)})"
        return "Mesh(" + ", ".join(f"{d}@{r}" for d, r in zip(
            self.devices, self.ranks)) + f"; {self.backend})"


# -- the process group ------------------------------------------------------------

def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(
        os.environ.get("DGRAPH_TPU_DIST_TIMEOUT_S", DIST_TIMEOUT_S)))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join a multi-process runtime over `torch.distributed` (the
    reference's `jax.distributed` bootstrap): after this, `make_mesh()`
    lays the shard axis over every process's devices. Driven by explicit
    arguments, the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID env trio, or, with JAX_DIST_AUTO=1, torchrun's env
    (`init_method="env://"`). A coordinator `host:port` becomes
    `tcp://host:port`; one given without the world size or this
    process's rank raises ValueError naming what is missing. Returns
    True when a multi-process runtime was joined. The group is gloo's;
    a mesh whose ranks own distinct cards adds an NCCL group of its own
    (`make_mesh`). A failed rendezvous raises."""
    if _joined():
        return dist.get_world_size() > 1
    timeout = _timeout()
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        if os.environ.get("JAX_DIST_AUTO") == "1":
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=timeout)
            return dist.get_world_size() > 1
        return False
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    missing = [what for what, v in (
        ("the number of processes (num_processes, JAX_NUM_PROCESSES)",
         num_processes),
        ("this process's rank (process_id, JAX_PROCESS_ID)", process_id))
        if v is None or v < 0]
    if missing:
        raise ValueError(f"init_distributed: coordinator {coordinator} "
                         f"given without {' and '.join(missing)}")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    return dist.get_world_size() > 1


def shutdown_distributed() -> None:
    """Leave the process group (a no-op outside one)."""
    if _joined():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    return dist.get_world_size() if _joined() else 1


def _local_devices(dev: torch.device) -> list:
    """The devices this process offers to a global mesh: its card or the
    CPU, DGRAPH_TPU_LOCAL_SHARDS times (default 1). A card named with
    its index is that card; a bare "cuda" is card LOCAL_RANK, else this
    rank modulo the cards this process sees."""
    k = int(os.environ.get(LOCAL_SHARDS_ENV, "1"))
    if k < 1:
        raise ValueError(f"a process offers at least one shard, not {k}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * k
    have = torch.cuda.device_count()
    if dev.index is not None:
        if dev.index >= have:
            raise ValueError(f"requested device {dev}, have {have}")
        return [dev] * k
    card = int(os.environ.get("LOCAL_RANK", process_index())) % have
    return [torch.device("cuda", card)] * k


def _global_mesh(n_devices, device) -> Mesh:
    """The mesh over every rank's local devices (rank order, then local
    order), its first `n_devices` (None or -1: all of them); agreed by
    one exchange of the ranks' device lists."""
    dev = resolve_device(device)
    local = _local_devices(torch.device(device))
    rank, world = dist.get_rank(), dist.get_world_size()
    offers: list = [None] * world
    dist.all_gather_object(offers, (dev.type, socket.gethostname(),
                                    [str(d) for d in local]))
    _count_cross("mesh_shape")
    if len({o[0] for o in offers}) != 1:
        raise ValueError(f"the processes offer devices of different types: "
                         f"{sorted({o[0] for o in offers})}")
    devices, ranks, cards = [], [], []
    for r, (_t, host, devs) in enumerate(offers):
        for s in devs:
            devices.append(torch.device(s))
            ranks.append(r)
            cards.append((host, s))
    n = len(devices) if n_devices is None or n_devices < 0 else int(
        n_devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)} over "
                         f"{world} processes")
    devices, ranks, cards = devices[:n], ranks[:n], cards[:n]
    owners = sorted(set(ranks))
    backend = group = None
    if len(owners) > 1:
        by_card: dict = {}
        for r, c in zip(ranks, cards):
            by_card.setdefault(c, set()).add(r)
        nccl = dev.type == "cuda" and all(len(rs) == 1
                                          for rs in by_card.values())
        backend = "nccl" if nccl else "gloo"
        if nccl:
            torch.cuda.set_device(local[0])
        # every rank of the world creates the group, in the same order
        group = dist.new_group(ranks=owners, backend=backend,
                               timeout=_timeout())
        if rank not in owners:
            group = None
    return Mesh(devices, ranks=ranks, rank=rank, group=group,
                backend=backend)


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """A 1-D mesh: over `devices` when given (this process's own; a
    device may repeat); else, inside a process group, the global mesh
    over every process's devices (DGRAPH_TPU_LOCAL_SHARDS shards per
    process) or its first `n_devices`; else over the first `n_devices`
    cards (default: all of them), or over `n_devices` shards of the CPU
    when `device="cpu"` (default 1). Raises without a card unless the
    caller names the CPU."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        for d in devs:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise ValueError(f"requested device {d}, have "
                                 f"{torch.cuda.device_count()}")
        return Mesh(devs, rank=process_index())
    if _joined():
        return _global_mesh(n_devices, device)
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"requested {n} devices")
        return Mesh([torch.device("cpu")] * n)
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n < 1 or have < n:
        raise ValueError(f"requested {n} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


# -- values on a mesh ----------------------------------------------------------

def _nbytes(parts) -> int:
    """Bytes the distinct tensors of `parts` hold here (a tensor shared
    by shards of one device counts once; other processes' count none)."""
    seen: dict = {}
    for p in parts:
        if p is not None:
            seen[id(p)] = p.numel() * p.element_size()
    return sum(seen.values())


def _held(parts) -> torch.Tensor:
    for p in parts:
        if p is not None:
            return p
    raise RuntimeError("this process holds no shard of the value")


class Sharded:
    """Shard d's slice of a value, `parts[d]` on `mesh.devices[d]` (None
    for another process's shard); reads on the host as the stacked `[D,
    ...]` array (`np.asarray`) when every part is held here. `mesh` is
    needed only where some part is not."""

    __slots__ = ("parts", "mesh")

    def __init__(self, parts, mesh: Mesh | None = None):
        self.parts = list(parts)
        self.mesh = mesh

    @property
    def nbytes(self) -> int:
        return _nbytes(self.parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts), *_held(self.parts).shape)

    @property
    def lead(self) -> torch.Tensor:
        """The first part held here."""
        return _held(self.parts)

    @property
    def fully_held(self) -> bool:
        return all(p is not None for p in self.parts)

    def prefix(self, n: int) -> "Sharded":
        """Each held part's first `n` entries of its last axis (views)."""
        return Sharded((None if p is None else p[..., :n]
                        for p in self.parts), self.mesh)

    def __array__(self, dtype=None, copy=None):
        if not self.fully_held:
            raise RuntimeError(
                "a sharded value with shards of other processes reads "
                "through host_np (which gathers it), not np.asarray")
        out = np.stack([p.cpu().numpy() for p in self.parts])
        return out if dtype is None else out.astype(dtype)


class Replicated:
    """One value every shard holds, `parts[d]` on `mesh.devices[d]`
    (shards of one device share the tensor; another process's shards
    are None); reads on the host as the local copy (`np.asarray`,
    `int`)."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def nbytes(self) -> int:
        return _nbytes(self.parts)

    @property
    def shape(self) -> tuple:
        return tuple(_held(self.parts).shape)

    def __array__(self, dtype=None, copy=None):
        out = _held(self.parts).cpu().numpy()
        return out if dtype is None else out.astype(dtype)

    def __int__(self) -> int:
        return int(_held(self.parts))


def gather_shards(x: Sharded, kind: str = "host_np") -> list:
    """Every shard's part of `x`: this process's as they are (views on
    their devices), the others' received by one gather over the mesh's
    group, counted under `kind`. A value whose parts are all held here
    makes no cross-process call; otherwise every process holding a shard
    of it must call this too."""
    if x.fully_held:
        return list(x.parts)
    if x.mesh is None:
        raise RuntimeError("a sharded value with shards of other "
                           "processes needs its mesh to be gathered")
    return _exchange(x.mesh, x.parts, kind)


def host_np(x) -> np.ndarray:
    """A program's output → host numpy. A replicated value is its local
    copy; a sharded one is every shard's part stacked (`gather_shards`:
    other processes' parts are gathered over the mesh's group, the
    reference's `process_allgather(tiled=True)`)."""
    if isinstance(x, Sharded):
        return np.stack([p.cpu().numpy() for p in gather_shards(x)])
    if isinstance(x, Replicated):
        return np.asarray(x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _per_device(mesh: Mesh, build) -> list:
    """`[build(devices[d]) for d]` over this process's shards (None for
    the others), each distinct device's built once."""
    memo: dict = {}
    out: list = [None] * mesh.size
    for d in mesh.local:
        dev = mesh.devices[d]
        if dev not in memo:
            memo[dev] = build(dev)
        out[d] = memo[dev]
    return out


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def replicate(mesh: Mesh, x) -> Replicated:
    """`x` held by every shard of this process: a host array is uploaded
    once per distinct device; a tensor or Replicated keeps every part
    already on its shard's device."""
    if isinstance(x, Replicated) and len(x.parts) == mesh.size:
        return Replicated(
            None if not mesh.is_local(d) else
            p if p.device == mesh.devices[d] else p.to(mesh.devices[d])
            for d, p in enumerate(x.parts))
    t = _as_tensor(x)
    return Replicated(_per_device(mesh, lambda dev: t.to(dev)))


def shard(mesh: Mesh, x) -> Sharded:
    """`x` split over the shard axis, this process's shards placed: a
    host `[D, ...]` array puts its row d on device d; a list gives shard
    d its item d; a Sharded keeps every part already in place."""
    if isinstance(x, Sharded):
        parts = x.parts
    elif isinstance(x, (list, tuple)):
        parts = list(x)
    else:
        t = _as_tensor(x)
        if t.shape[0] != mesh.size:
            raise ValueError(f"leading axis {t.shape[0]} != mesh size "
                             f"{mesh.size}")
        parts = list(t.unbind(0))
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} shards for a mesh of {mesh.size}")
    return Sharded((_as_tensor(p).to(dev) if mesh.is_local(d) else None
                    for d, (p, dev) in enumerate(zip(parts, mesh.devices))),
                   mesh)


@dataclass(frozen=True)
class Placement:
    """Where a value goes on a mesh: split along its leading axis
    (`shard_leading`) or held by every shard (`replicated`)."""

    mesh: Mesh
    spec: tuple

    def put(self, x):
        return (shard(self.mesh, x) if self.spec == SHARDED
                else replicate(self.mesh, x))


def shard_leading(mesh: Mesh) -> Placement:
    """The placement that splits a value's leading axis over the mesh."""
    return Placement(mesh, SHARDED)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, REPLICATED)


def device_put(x, placement: Placement):
    return placement.put(x)


# -- collectives -----------------------------------------------------------------

def _parts(mesh: Mesh, xs) -> list:
    parts = xs.parts if isinstance(xs, (Sharded, Replicated)) else list(xs)
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} operands for a mesh of {mesh.size}")
    return parts


def _exchange(mesh: Mesh, parts: list, kind: str) -> list:
    """Every shard's operand, here: this process's parts as they are,
    the others' received by one `all_gather` over the mesh's group (on
    the host over gloo, on this process's card over NCCL). Each rank
    sends its parts stacked, padded to the most shards any rank owns;
    every operand has the held parts' shape and dtype."""
    if not mesh.spans_processes:
        return list(parts)
    if mesh.group is None:
        raise RuntimeError(f"process {mesh.rank} holds no shard of this "
                           f"mesh")
    mine = [parts[d] for d in mesh.local]
    if any(p is None for p in mine):
        raise ValueError("an operand of this process's shard is missing")
    first = mine[0]
    stage = torch.device("cpu") if mesh.backend == "gloo" else first.device
    as_bool = first.dtype == torch.bool
    send = torch.stack([(p.to(torch.uint8) if as_bool else p).to(stage)
                        for p in mine])
    if len(mine) < mesh._width:
        send = torch.cat([send, send.new_zeros(
            (mesh._width - len(mine), *send.shape[1:]))])
    recv = [torch.empty_like(send) for _ in mesh.owners]
    dist.all_gather(recv, send.contiguous(), group=mesh.group)
    _count_cross(kind)
    out = list(parts)
    for d in range(mesh.size):
        if out[d] is None:
            got = recv[mesh.owners.index(mesh.ranks[d])][mesh._slot[d]]
            out[d] = got.to(torch.bool) if as_bool else got
    return out


def all_gather(mesh: Mesh, xs) -> list:
    """Every shard's `[D, ...]` stack of the shards' operands."""
    parts = _exchange(mesh, _parts(mesh, xs), "all_gather")
    return _per_device(mesh, lambda dev: torch.stack(
        [p.to(dev) for p in parts]))


def psum(mesh: Mesh, xs) -> list:
    """The operands' sum on every shard, added in shard order in the
    operands' dtype (int8 lane sums stay int8)."""
    parts = _exchange(mesh, _parts(mesh, xs), "psum")

    def total(dev):
        acc = parts[0].to(dev, copy=True)
        for p in parts[1:]:
            acc += p.to(dev)
        return acc

    return _per_device(mesh, total)


def pmax(mesh: Mesh, xs) -> list:
    """The operands' elementwise maximum on every shard."""
    parts = _exchange(mesh, _parts(mesh, xs), "pmax")

    def top(dev):
        acc = parts[0].to(dev)
        for p in parts[1:]:
            acc = torch.maximum(acc, p.to(dev))
        return acc

    return _per_device(mesh, top)


def ppermute(mesh: Mesh, xs, perm) -> list:
    """Shard `dst` receives shard `src`'s operand for each `(src, dst)`
    of `perm`; a shard that receives nothing gets zeros. Across
    processes the operands travel by the same gather as the others."""
    parts = _exchange(mesh, _parts(mesh, xs), "ppermute")
    out: list = [None] * mesh.size
    for src, dst in perm:
        if mesh.is_local(dst):
            out[dst] = parts[src].to(mesh.devices[dst])
    return [None if not mesh.is_local(d) else
            o if o is not None else torch.zeros_like(
                parts[d].to(mesh.devices[d]))
            for d, o in enumerate(out)]


def psum_scatter(mesh: Mesh, xs, scatter_dimension: int = 0,
                 tiled: bool = True) -> list:
    """The operands' sum, split along `scatter_dimension` into D equal
    blocks: shard d keeps block d (`tiled`), or index d of that
    dimension (not `tiled`)."""
    sums = psum(mesh, xs)
    n = _held(sums).shape[scatter_dimension]
    out: list = [None] * mesh.size
    for d in mesh.local:
        s = sums[d]
        if tiled:
            if n % mesh.size:
                raise ValueError(f"dimension {n} does not split into "
                                 f"{mesh.size} blocks")
            rows = n // mesh.size
            out[d] = s.narrow(scatter_dimension, d * rows, rows)
        else:
            out[d] = s.select(scatter_dimension, d)
    return out


# -- reshard accounting ------------------------------------------------------------

def hop_input(x, mesh: Mesh, spec=REPLICATED):
    """Count an unexpected reshard on a hop input; returns `x` unchanged.
    Host arrays (a chain's seed) are uploads, not reshards. A sharded
    input must be a `Sharded` whose local parts lie on their shards'
    devices; a replicated input a `Replicated` likewise, or one tensor
    on the device every local shard lives on. Only this process's parts
    are judged."""
    if isinstance(x, torch.Tensor):
        ok = spec == REPLICATED and all(mesh.devices[d] == x.device
                                        for d in mesh.local)
    elif isinstance(x, (Sharded, Replicated)):
        want = Sharded if spec == SHARDED else Replicated
        ok = (isinstance(x, want) and len(x.parts) == mesh.size
              and all(x.parts[d] is not None
                      and x.parts[d].device == mesh.devices[d]
                      for d in mesh.local))
    else:
        ok = True
    if not ok:
        METRICS.inc("mesh_hop_resharded_total")
    return x


def reshard_count() -> int:
    return int(METRICS.get("mesh_hop_resharded_total"))


@contextlib.contextmanager
def reshard_guard(strict: bool = True):
    """Assert the steady path stayed reshard-free: no
    `mesh_hop_resharded_total` increment inside the block (armed around
    the hop loops by the engine and by the bit-identity tests)."""
    before = reshard_count()
    yield
    after = reshard_count()
    if strict and after != before:
        raise AssertionError(
            f"{after - before} unexpected cross-device reshard(s) on a "
            f"steady hop path: a hop's output placement differs from the "
            f"next hop's input (see parallel/mesh.py hop_input)")
