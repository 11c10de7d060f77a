"""The device mesh of one process, its placements and its collectives.

Port of `dgraph_tpu/parallel/mesh.py`. The reference's topology is a
`jax.sharding.Mesh` with one named axis, "shard", over which posting-store
rows are partitioned and across which the hop programs' collectives run.
Here a `Mesh` is an ordered tuple of `torch.device`s on that one axis.
`make_mesh(n)` takes the first n cards; an explicit `devices` list may
name one card more than once, which is how one card holds several
shards (the card's counterpart of the reference tests'
`--xla_force_host_platform_device_count`); `device="cpu"` gives n shards
on the CPU, the tests' mesh.

Values on a mesh come in two forms, the reference's two PartitionSpecs:

* `Sharded(parts)` (`P("shard")`): shard d's own slice, `parts[d]` on
  `mesh.devices[d]`;
* `Replicated(parts)` (`P()`): the same value held by every shard. Shards
  that share a device share ONE tensor (`parts[d] is parts[e]`): four
  shards of one card hold one copy of a replicated frontier, not four.

Shards are a Python list, not one stacked `[D, ...]` tensor, so shards
on distinct cards and shards on one card run the same code. The
reference's `shard_map` programs become plain functions: each program
(`dhop.py`, `dsort.py`, `dbfs.py`, `store/vec.py`, `engine/feat.py`) runs
its per-shard body once per shard, one shard after another, on the
current stream of the shard's device, and splits at each collective.

The collectives live here and nowhere else (graftlint R7): `all_gather`,
`psum`, `pmax`, `ppermute` and `psum_scatter` over a list of per-shard
tensors. Each result is computed once per distinct device: on shards of
one card they are device ops (stack, sum, max, a rotation of the list);
across distinct cards each operand is copied device to device
(`Tensor.to`). No collective goes through the host.

The steady serving contract is the reference's: a hop's outputs are the
next hop's inputs with their placement already right, so a chained
frontier crosses no device boundary between launches. `hop_input` is the
guard at every hop entry and counts `mesh_hop_resharded_total` when a
sharded input's parts are not on the mesh's devices in the mesh's order,
or a replicated input lies off a shard's device; a host numpy seed is an
upload, not a reshard. `reshard_guard` raises when the count moved
inside its block.

`host_np` is the single-process `.cpu().numpy()`. The multi-process form
(`init_distributed` over `torch.distributed`, NCCL on cards, gloo on the
CPU) is ROADMAP item 10b: `init_distributed` raises.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch.utils.device import resolve_device
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["SHARD_AXIS", "REPLICATED", "SHARDED", "Mesh", "Sharded",
           "Replicated", "Placement", "make_mesh", "init_distributed",
           "host_np", "shard_leading", "replicated", "device_put",
           "replicate", "shard", "all_gather", "psum", "pmax", "ppermute",
           "psum_scatter", "hop_input", "reshard_count", "reshard_guard",
           "PROGRAM_CALLS", "count_program"]

SHARD_AXIS = "shard"
# the reference's PartitionSpecs: P() and P("shard")
REPLICATED: tuple = ()
SHARDED: tuple = (SHARD_AXIS,)

# mesh programs run, by name (each program counts one per call, whatever
# the shards and ops inside it); chip_smoke.py zeroes it before a main
# path and reads it after
PROGRAM_CALLS: dict[str, int] = {}


def count_program(name: str) -> None:
    PROGRAM_CALLS[name] = PROGRAM_CALLS.get(name, 0) + 1


class Mesh:
    """An ordered tuple of devices on the one axis `SHARD_AXIS`. A
    device may repeat: then several shards share it."""

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in devs}
        if len(types) != 1:
            raise ValueError(f"a mesh spans one device type, got "
                             f"{sorted(types)}")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def make_mesh(n_devices: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """A 1-D mesh: over `devices` when given (a device may repeat), else
    over the first `n_devices` cards (default: all of them), or over
    `n_devices` shards of the CPU when `device="cpu"` (default 1).
    Raises without a card unless the caller names the CPU."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        for d in devs:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise ValueError(f"requested device {d}, have "
                                 f"{torch.cuda.device_count()}")
        return Mesh(devs)
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


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """A mesh across processes (the reference's `jax.distributed`
    bootstrap) is ROADMAP item 10b; this slice serves one process."""
    raise NotImplementedError(
        "a mesh across processes (torch.distributed: NCCL on cards, gloo "
        "on the CPU) is ROADMAP item 10b; this process serves a mesh of "
        "its own devices only")


# -- values on a mesh ----------------------------------------------------------

def _nbytes(parts) -> int:
    """Bytes the distinct tensors of `parts` hold (a tensor shared by
    shards of one device counts once)."""
    seen: dict = {}
    for p in parts:
        seen[id(p)] = p.numel() * p.element_size()
    return sum(seen.values())


class Sharded:
    """Shard d's slice of a value, `parts[d]` on `mesh.devices[d]`; reads
    on the host as the stacked `[D, ...]` array (`np.asarray`)."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def nbytes(self) -> int:
        return _nbytes(self.parts)

    @property
    def shape(self) -> tuple:
        return (len(self.parts), *self.parts[0].shape)

    def __array__(self, dtype=None, copy=None):
        out = np.stack([p.cpu().numpy() for p in self.parts])
        return out if dtype is None else out.astype(dtype)


class Replicated:
    """One value every shard holds, `parts[d]` on `mesh.devices[d]`
    (shards of one device share the tensor); reads on the host as that
    value (`np.asarray`, `int`)."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def nbytes(self) -> int:
        return _nbytes(self.parts)

    @property
    def shape(self) -> tuple:
        return tuple(self.parts[0].shape)

    def __array__(self, dtype=None, copy=None):
        out = self.parts[0].cpu().numpy()
        return out if dtype is None else out.astype(dtype)

    def __int__(self) -> int:
        return int(self.parts[0])


def host_np(x) -> np.ndarray:
    """A program's output → host numpy (single process: one copy)."""
    if isinstance(x, (Sharded, Replicated)):
        return np.asarray(x)
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _per_device(mesh: Mesh, build) -> list:
    """`[build(devices[d]) for d]`, each distinct device's built once."""
    memo: dict = {}
    out = []
    for dev in mesh.devices:
        if dev not in memo:
            memo[dev] = build(dev)
        out.append(memo[dev])
    return out


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def replicate(mesh: Mesh, x) -> Replicated:
    """`x` held by every shard: a host array is uploaded once per
    distinct device; a tensor or Replicated keeps every part already on
    its shard's device."""
    if isinstance(x, Replicated) and len(x.parts) == mesh.size:
        return Replicated(p if p.device == dev else p.to(dev)
                          for p, dev in zip(x.parts, mesh.devices))
    t = _as_tensor(x)
    return Replicated(_per_device(mesh, lambda dev: t.to(dev)))


def shard(mesh: Mesh, x) -> Sharded:
    """`x` split over the shard axis: a host `[D, ...]` array puts its
    row d on device d; a Sharded keeps every part already in place."""
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
    return Sharded(_as_tensor(p).to(dev)
                   for p, dev in zip(parts, mesh.devices))


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


def all_gather(mesh: Mesh, xs) -> list:
    """Every shard's `[D, ...]` stack of the shards' operands."""
    parts = _parts(mesh, xs)
    return _per_device(mesh, lambda dev: torch.stack(
        [p.to(dev) for p in parts]))


def psum(mesh: Mesh, xs) -> list:
    """The operands' sum on every shard, added in shard order in the
    operands' dtype (int8 lane sums stay int8)."""
    parts = _parts(mesh, xs)

    def total(dev):
        acc = parts[0].to(dev, copy=True)
        for p in parts[1:]:
            acc += p.to(dev)
        return acc

    return _per_device(mesh, total)


def pmax(mesh: Mesh, xs) -> list:
    """The operands' elementwise maximum on every shard."""
    parts = _parts(mesh, xs)

    def top(dev):
        acc = parts[0].to(dev)
        for p in parts[1:]:
            acc = torch.maximum(acc, p.to(dev))
        return acc

    return _per_device(mesh, top)


def ppermute(mesh: Mesh, xs, perm) -> list:
    """Shard `dst` receives shard `src`'s operand for each `(src, dst)`
    of `perm`; a shard that receives nothing gets zeros."""
    parts = _parts(mesh, xs)
    out: list = [None] * mesh.size
    for src, dst in perm:
        out[dst] = parts[src].to(mesh.devices[dst])
    return [o if o is not None else torch.zeros_like(parts[d])
            for d, o in enumerate(out)]


def psum_scatter(mesh: Mesh, xs, scatter_dimension: int = 0,
                 tiled: bool = True) -> list:
    """The operands' sum, split along `scatter_dimension` into D equal
    blocks: shard d keeps block d (`tiled`), or index d of that
    dimension (not `tiled`)."""
    sums = psum(mesh, xs)
    n = sums[0].shape[scatter_dimension]
    out = []
    for d, s in enumerate(sums):
        if tiled:
            if n % mesh.size:
                raise ValueError(f"dimension {n} does not split into "
                                 f"{mesh.size} blocks")
            rows = n // mesh.size
            out.append(s.narrow(scatter_dimension, d * rows, rows))
        else:
            out.append(s.select(scatter_dimension, d))
    return out


# -- reshard accounting ------------------------------------------------------------

def hop_input(x, mesh: Mesh, spec=REPLICATED):
    """Count an unexpected reshard on a hop input; returns `x` unchanged.
    Host arrays (a chain's seed) are uploads, not reshards. A sharded
    input must be a `Sharded` whose parts lie on the mesh's devices in
    the mesh's order; a replicated input a `Replicated` likewise, or one
    tensor on the device every shard lives on."""
    if isinstance(x, torch.Tensor):
        ok = spec == REPLICATED and all(d == x.device for d in mesh.devices)
    elif isinstance(x, (Sharded, Replicated)):
        want = Sharded if spec == SHARDED else Replicated
        ok = (isinstance(x, want) and len(x.parts) == mesh.size
              and all(p.device == d for p, d in zip(x.parts, mesh.devices)))
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
