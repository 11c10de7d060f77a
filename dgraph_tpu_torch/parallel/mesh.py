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
* the decisions one rank could make differently from another are made
  once, by the lead (`Mesh.is_lead`, rank 0), and followed by every
  rank (`agree`, below): an Alpha's admission verdict and the order in
  which its requests run, the cost priors' learned route promotions
  (`promoted`), and the groups `query_batch` sends to lane kernels;
* overflow re-runs decide on replicated values (a program's `needs`,
  merged by `pmax`), identical on every rank;
* placement (`Store.sharded_rel`, `Store.vec_sharded`, the sort-key
  columns) makes no collective, so one rank's eviction and re-placement
  cannot put the ranks out of step;
* a failure on one rank is known to every rank at the next collective
  boundary (below), so every rank takes the same path after it.

**Failures every rank sees.** While the mesh spans processes, every
collective first makes one status round: each rank sends a small
fixed-size header (`STATUS_BYTES`) by one `all_gather` over the mesh's
gloo group (`Mesh.status_group`), counted in `CROSS_CALLS["status"]`.
A header holds the rank's status (ok; an allocation failure at a site;
a deadline expired or a request cancelled at a stage; another error)
and the identity of the collective: the outermost scope's name and
this process's ordinal for it, the round's ordinal inside that scope,
the program, and the collective's kind and operand shape. If any
header is not ok, no payload moves and every rank raises the same
failure, the lowest failing rank's: that rank raises its own
exception, every other rank one of the same class (the allocation
error's, `DeadlineExceeded` or `Cancelled` with the same stage, else
`MeshFailure`) naming the failing rank, its site or stage and its
program. If every header is ok but the identities differ, every rank
raises `MeshFailure` naming each rank's identity, and nothing is
folded. The exception a round raises carries what was agreed
(`failure_of`), and no round follows it in its scope.

The rounds happen inside scopes. Every mesh program runs inside
`program(mesh, name)`, which counts it in `PROGRAM_CALLS`; a route that
reads a program's outputs runs inside `lockstep(mesh, name)`, an
Alpha's request over the mesh inside `lockstep(mesh, "request", turn)`
(`server/api.py`), each attempt of an allocation-failure retry inside
`attempt(mesh, site)` (`memgov.oom_retry`), and a gather called outside
every scope opens its own. The outermost scope of a thread holds the
rounds and ends with one closing round, so a failure after a program's
last collective is seen too; a scope nested in another leaves its
closing to the outermost one. Three scopes close otherwise: a gather's
own scope makes no closing round (nothing that can fail on one rank
follows its gather), a write's request scope closes only when it made
a round (`lazy`: a write that used no collective needs no peer), and
an attempt reports its own failures even when nested. When a scope
that reports catches an exception no round has agreed, the rank
reports it at a round instead of leaving: its peers meet that round at
their next collective inside the same scope. So:

* an allocation failure on any rank inside an attempt, met by every
  rank before it leaves the attempt, is retried by every rank: each
  evicts to its low watermark (only the failing rank counts
  `oom_events_total`) and runs the attempt again; a second one raises
  on every rank, and so does a failure met after a rank left the
  attempt;
* a read whose budget runs out on one rank raises `DeadlineExceeded`
  at its checkpoint there, as in the reference; its request scope
  reports it, and every rank that meets the report at a collective
  raises it too, naming the same stage;
* an Alpha's read ends with a turn round before it gives up its turn,
  so the next request's collectives never meet this one's. A rank whose
  read completed learns a peer's failure at that round and still
  answers: a failure in a host-only tail (rendering) stays per rank, as
  in the reference. A write makes a turn round only when it made a
  round (so a client may send a write that uses no collective to one
  rank after another);
* a round whose ranks stand in different requests (a write that one
  rank left before its first round while another went on into its
  collectives) ends the earlier request on the ranks behind, with
  `MeshFailure`; the ranks ahead meet the same round again, which the
  ranks behind reach in their next request. Ranks never stay out of
  step from one request to the next.

A mesh of one process makes no round. Every wait is bounded by the
group's timeout. Nothing falls back to a single-process mesh or to the
host.

The lead's decisions travel through the process group's own key-value
store (the `TCPStore` of the rendezvous, under the prefix
`AGREE_PREFIX`), never as collectives on the mesh's group: request
threads run concurrently, and a collective from one would interleave
with the programs' collectives in another order on each rank. `agree`
publishes the lead's decision under a key (one store write per
follower) and every other rank reads it (one store read, which waits
up to the group's timeout and then raises naming the key; a follower
never decides for itself). Each call counts in `CROSS_CALLS["agree"]`.
A key is the same on every rank without a word between them
(`agree_key`): the decision's kind and a hash of what identifies it
(an Alpha request's lane, text and variables; a batch's query texts),
`kind/<hash>`, nothing else. It depends on no order in which a rank
meets distinct requests, which threads may interleave differently on
each rank.

Identical requests share their key, and take it in turns: on each
rank the agreements under one key run one at a time (`_OCCURRENCES`
holds a lock per key while some thread agrees under it), the lead
publishes a decision only after every follower has read and deleted
the one before it under that key (it waits up to the group's timeout),
and each follower reads and deletes its own copy (`<key>@<rank>`). So
the i-th agreement under a key on a follower reads the lead's i-th,
as every rank receives the same requests, and no follower ever reads
a decision left for an earlier request. The bounds: the store holds
one key per follower for each decision some follower has not read
yet, and `_OCCURRENCES` one entry per key some thread of this process
is agreeing under (at most its threads inside `agree`); neither grows
with the number of distinct requests served.

The steady serving contract is the reference's: a hop's outputs are the
next hop's inputs with their placement already right, so a chained
frontier crosses no device boundary between launches. `hop_input` is the
guard at every hop entry and counts `mesh_hop_resharded_total` when a
local part of a sharded input is not on its shard's device, or a
replicated input lies off a local shard's device; a host numpy seed is
an upload, not a reshard. `reshard_guard` raises when the count moved
inside its block.

`CROSS_CALLS` counts this process's cross-process calls by kind (the
kinds are `CROSS_KINDS`); a mesh whose shards are all local makes none,
even inside a process group (the reference's `is_fully_addressable`
rule), and neither do its requests and batches agree on anything.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import datetime
import hashlib
import json
import os
import socket
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from dgraph_tpu_torch.utils import costprior, deadline, locks, memgov
from dgraph_tpu_torch.utils.device import resolve_device
from dgraph_tpu_torch.utils.metrics import METRICS

__all__ = ["SHARD_AXIS", "REPLICATED", "SHARDED", "Mesh", "Sharded",
           "Replicated", "Placement", "make_mesh", "init_distributed",
           "shutdown_distributed", "process_index", "process_count",
           "host_np", "shard_leading", "replicated", "device_put",
           "replicate", "shard", "gather_shards", "all_gather", "psum",
           "pmax", "ppermute", "psum_scatter", "hop_input", "reshard_count",
           "reshard_guard", "agree", "agree_key", "following", "promoted",
           "group_timeout_s", "PROGRAM_CALLS", "program",
           "lockstep", "attempt", "failure_of", "Failure", "MeshFailure",
           "CROSS_CALLS", "CROSS_KINDS", "AGREE_PREFIX", "DIST_TIMEOUT_S",
           "LOCAL_SHARDS_ENV", "STATUS_BYTES", "gather_columns"]

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

# the kinds of cross-process call: a collective's name, "host_np",
# "nnz" for assemble_sharded_rel's agreement, "mesh_shape", "agree" for
# a read or write of the lead's decisions, and "status" for a status
# round
CROSS_KINDS = ("all_gather", "psum", "pmax", "ppermute", "host_np", "nnz",
               "mesh_shape", "agree", "status")
# this process's cross-process calls, by kind
CROSS_CALLS: dict[str, int] = {}

# the store prefix of the lead's decisions (`agree`)
AGREE_PREFIX = "dgraph_tpu/agree"
# the process group's store under AGREE_PREFIX while this process is in
# a group (init_distributed), else None
_DECISIONS = None
# per key some thread is agreeing under: [its lock, threads using it]
_OCCURRENCES: dict = {}
_occurrence_lock = locks.make_lock("mesh.agree")
# bytes of one rank's header in a status round
STATUS_BYTES = 512
# the outermost scope this thread runs on a mesh across processes
_FRAME: contextvars.ContextVar = contextvars.ContextVar(
    "dgraph_tpu_mesh_frame", default=None)
# per outermost scope name: how many this process has opened
_FRAME_CALLS: dict = {}
# the lead's route promotions for the request this thread serves
_FOLLOWING: contextvars.ContextVar = contextvars.ContextVar(
    "dgraph_tpu_lead_promotions", default=None)


def _count_cross(kind: str) -> None:
    if kind not in CROSS_KINDS:
        raise ValueError(f"unknown cross-process call kind {kind!r}")
    CROSS_CALLS[kind] = CROSS_CALLS.get(kind, 0) + 1


# -- failures every rank sees (the module doc) ------------------------------------

class MeshFailure(RuntimeError):
    """Every rank's exception for a round whose ranks stand at different
    collectives, and a rank's for another rank's failure that is neither
    an allocation failure nor an expired or cancelled request."""


@dataclass(frozen=True)
class Failure:
    """What a status round agreed, on the exception each rank raises:
    the failing `rank` whose failure every rank raises (the lowest), its
    `kind` ("alloc", "deadline", "cancelled", "error"; "mismatch" for
    identities that differ, "behind" on a rank whose peers have left
    its request, "transport" for a round or a gather that
    did not complete), whether this rank reported a failure of its own
    (`mine`), and whether every failure was an allocation failure inside
    the attempt every rank stood in (`retry`)."""

    rank: int
    kind: str
    mine: bool
    retry: bool


def failure_of(e: BaseException) -> Failure | None:
    """The agreed failure `e` carries, or None when no round agreed it."""
    return getattr(e, "mesh_failure", None)


class _Frame:
    """The outermost scope of a thread on a mesh across processes: its
    name and ordinal, whether it closes only when it made a round
    (`lazy`), its rounds so far, and the program and attempt the thread
    is in."""

    __slots__ = ("mesh", "name", "call", "lazy", "rounds", "program",
                 "attempt")

    def __init__(self, mesh, name: str, call: int, lazy: bool = False):
        self.mesh = mesh
        self.name = name
        self.call = call
        self.lazy = lazy
        self.rounds = 0
        self.program = None
        self.attempt = None


@contextlib.contextmanager
def _scope(mesh, name: str, program: str | None = None,
           attempt: bool = False, turn: int | None = None,
           lazy: bool = False, bare: bool = False):
    """A scope on `mesh` (the module doc): the outermost on this thread
    opens a frame, ordinal `turn` when given, and ends with a closing
    round (its turn round, with a `turn`), unless it is `bare` (a
    gather's own) or `lazy` and made no round; a nested one marks the
    frame's program or attempt. The outermost scope and an attempt
    report an exception no round agreed (a lazy frame only once it made
    a round)."""
    if mesh is None or not mesh.spans_processes or mesh.status_group is None:
        yield
        return
    f = _FRAME.get()
    outer = f is None
    token = None
    if outer:
        call = turn
        if call is None:
            with _occurrence_lock:
                call = _FRAME_CALLS.get(name, 0)
                _FRAME_CALLS[name] = call + 1
        f = _Frame(mesh, name, call, lazy)
        token = _FRAME.set(f)
    saved = (f.program, f.attempt)
    if program is not None:
        f.program = program
    if attempt:
        f.attempt = [name, f.rounds]
    try:
        yield
    except Exception as e:
        if failure_of(e) is None and (attempt or (
                outer and (f.rounds or not f.lazy))):
            _round(f, "report", own=e)
        raise
    else:
        if outer and not bare and (f.rounds or not f.lazy):
            _round(f, "turn" if turn is not None else "close")
    finally:
        f.program, f.attempt = saved
        if token is not None:
            _FRAME.reset(token)


@contextlib.contextmanager
def program(mesh: "Mesh", name: str):
    """Run the block as mesh program `name`: one call in
    `PROGRAM_CALLS`, and a scope whose rounds name the program."""
    PROGRAM_CALLS[name] = PROGRAM_CALLS.get(name, 0) + 1
    with _scope(mesh, name, program=name):
        yield


@contextlib.contextmanager
def lockstep(mesh: "Mesh", name: str, turn: int | None = None,
             lazy: bool = False):
    """Run the block as one scope on `mesh` (a route that reads a
    program's outputs, or, with its `turn`, an Alpha's request): one
    closing round for all its collectives when it is the outermost,
    and with `lazy` (a write) only when it made a round. A request's
    closing round is its turn round: a rank whose request completed
    learns a peer's failure there and does not raise it."""
    with _scope(mesh, name, turn=turn, lazy=lazy):
        yield


@contextlib.contextmanager
def attempt(mesh: "Mesh", site: str):
    """One attempt of an allocation-failure retry at `site`: a scope
    that reports its own failures, so every rank still inside the
    attempt learns of a failure in it (`memgov.oom_retry`). Nested in
    another scope it makes no closing round of its own."""
    with _scope(mesh, site, attempt=True):
        yield


def _describe(f: _Frame, e: BaseException) -> dict:
    """The header fields of this rank's own failure `e`."""
    prog = f.program or f.name
    if isinstance(e, deadline.DeadlineExceeded):
        kind, where = "deadline", e.stage
    elif isinstance(e, deadline.Cancelled):
        kind, where = "cancelled", e.stage
    elif memgov.is_alloc_failure(e):
        kind, where = "alloc", f.attempt[0] if f.attempt else prog
    else:
        kind, where = "error", prog
    return {"k": kind, "w": str(where)[:64], "p": prog[:64],
            "c": type(e).__name__[:64], "m": str(e)}


def _encode(head: dict) -> torch.Tensor:
    """`head` as JSON in STATUS_BYTES zero-padded bytes (the failure's
    message cut until it fits)."""
    for cut in (None, 200, 40, 0):
        if cut is not None and "m" in head:
            head["m"] = head["m"][:cut]
        raw = json.dumps(head).encode()
        if len(raw) <= STATUS_BYTES:
            break
    else:
        raise ValueError(f"a status header of {len(raw)} bytes")
    out = torch.zeros(STATUS_BYTES, dtype=torch.uint8)
    out[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return out


def _ident(h: dict) -> str:
    name, call, rnd, prog, what, shape = h["id"]
    return (f"rank {h['r']} at {name} #{call} round {rnd} ({prog}, "
            f"{what}{'' if shape is None else f' of {shape}'})")


_ALLOC_CLASSES = {"AllocFault": memgov.AllocFault,
                  "OutOfMemoryError": torch.cuda.OutOfMemoryError}


def _rebuild(h: dict) -> Exception:
    """A peer's failure as this rank raises it: the same class."""
    msg = (f"rank {h['r']} failed at {h['w']} in {h['p']}: {h['c']}: "
           f"{h['m']}")
    if h["k"] == "alloc":
        return _ALLOC_CLASSES.get(h["c"], MemoryError)(msg)
    if h["k"] == "deadline":
        return deadline.DeadlineExceeded(msg, stage=h["w"])
    if h["k"] == "cancelled":
        return deadline.Cancelled(msg, stage=h["w"])
    return MeshFailure(msg)


def _agreed(e: BaseException, failure: Failure) -> BaseException:
    e.mesh_failure = failure
    return e


def _round(f: _Frame, what: str, own: BaseException | None = None,
           shape=None) -> None:
    """One status round of frame `f` before its collective `what` (or
    its closing, turn or report round): gather every rank's header;
    raise the agreed failure or mismatch, or return when every rank is
    ok at the same collective. `own` is this rank's failure to report."""
    mesh = f.mesh
    f.rounds += 1
    head = {"a": f.attempt,
            "id": [f.name, f.call, f.rounds, f.program or f.name, what,
                   shape]}
    if own is not None:
        head.update(_describe(f, own))
    send = _encode(head)
    recv = [torch.empty_like(send) for _ in mesh.owners]
    try:
        dist.all_gather(recv, send, group=mesh.status_group)
    except Exception as e:
        raise _agreed(MeshFailure(
            f"process {mesh.rank}: the status round at {f.name} #{f.call} "
            f"round {f.rounds} did not complete within the group's "
            f"timeout ({group_timeout_s():g} s): {e}"),
            Failure(mesh.rank, "transport", own is not None,
                    False)) from (own or e)
    _count_cross("status")
    if own is None and all(torch.equal(r, send) for r in recv):
        return      # every rank ok at this same collective
    heads = [json.loads(bytes(r.numpy()).rstrip(b"\0")) for r in recv]
    for owner, h in zip(mesh.owners, heads):
        h["r"] = owner
    turns = {h["id"][1] for h in heads}
    if len(turns) > 1 and all(h["id"][0] == "request" for h in heads):
        if f.call < max(turns):
            if own is None and what == "turn":
                return      # it completed here; the ranks ahead left it
            # the ranks ahead have left this request: it ends here
            raise _agreed(MeshFailure(
                f"process {mesh.rank}: the ranks ahead have left request "
                f"{f.call}: " + "; ".join(_ident(h) for h in heads)),
                Failure(mesh.rank, "behind", own is not None,
                        False)) from own
        # the ranks behind end their earlier request, and meet this
        # round again in their next one
        f.rounds -= 1
        return _round(f, what, own, shape)
    bad = [h for h in heads if "k" in h]
    if not bad:
        raise _agreed(MeshFailure(
            "the ranks stand at different collectives: "
            + "; ".join(_ident(h) for h in heads)),
            Failure(heads[0]["r"], "mismatch", False, False))
    first = min(bad, key=lambda h: h["r"])
    failure = Failure(
        first["r"], first["k"], own is not None,
        all(h["k"] == "alloc" for h in bad) and heads[0]["a"] is not None
        and all(h["a"] == heads[0]["a"] for h in heads))
    if own is None and what == "turn":
        # this rank's request completed: it learns the peer's failure
        # at its turn round and answers
        return
    if own is not None and first["r"] == mesh.rank:
        raise _agreed(own, failure)
    # this rank's request ends here as the failing rank's did
    if own is None and first["k"] == "deadline":
        METRICS.inc("deadline_exceeded_total", stage=first["w"])
    elif own is None and first["k"] == "cancelled":
        METRICS.inc("request_cancelled_total", stage=first["w"])
    raise _agreed(_rebuild(first), failure) from own


class Mesh:
    """An ordered tuple of devices on the one axis `SHARD_AXIS`. A
    device may repeat: then several shards share it. `ranks[d]` is the
    process that owns shard d; this process (`rank`) holds the shards
    in `local`, and reaches the others through `group` over `backend`
    (both None when every shard is local); its status rounds go over
    `status_group`, a gloo group (`group` itself under gloo)."""

    def __init__(self, devices, ranks=None, rank: int = 0, group=None,
                 backend: str | None = None, status_group=None):
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
        self.status_group = status_group if status_group is not None \
            else group
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
    def is_lead(self) -> bool:
        """Whether this process is the mesh's lead (its first owner,
        rank 0): the one whose decisions every rank follows (`agree`)."""
        return self.rank == self.owners[0]

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
            return _join("env://", -1, -1, timeout)
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
    return _join(url, int(num_processes), int(process_id), timeout)


def _join(url: str, world_size: int, rank: int, timeout) -> bool:
    """Rendezvous at `url` (what `init_process_group(init_method=url)`
    does), keep its store for the lead's decisions, and build the gloo
    group over it. A process that exits still in the group leaves it
    first (`shutdown_distributed` at exit): torch's own teardown of a
    group whose peer is gone can abort the process."""
    global _DECISIONS
    store, rank, world_size = next(dist.rendezvous(
        url, rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    _DECISIONS = dist.PrefixStore(AGREE_PREFIX, store)
    atexit.unregister(shutdown_distributed)
    atexit.register(shutdown_distributed)
    return dist.get_world_size() > 1


def shutdown_distributed() -> None:
    """Leave the process group (a no-op outside one) and forget its
    decisions' store, keys and scope ordinals."""
    global _DECISIONS
    if _joined():
        dist.destroy_process_group()
    _DECISIONS = None
    with _occurrence_lock:
        _OCCURRENCES.clear()
        _FRAME_CALLS.clear()


def group_timeout_s() -> float:
    """How long a rendezvous, a collective or a read of the lead's
    decision waits for the other ranks before it raises."""
    return _timeout().total_seconds()


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
    backend = group = status = None
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
        # the status rounds' headers stay on the host
        status = dist.new_group(ranks=owners, backend="gloo",
                                timeout=_timeout()) if nccl else group
        if rank not in owners:
            group = status = None
    return Mesh(devices, ranks=ranks, rank=rank, group=group,
                backend=backend, status_group=status)


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
    return gather_columns([x], kind)[0]


def gather_columns(xs, kind: str = "host_np") -> list:
    """`gather_shards` of each sharded value of `xs` (one mesh, every
    part of one value the same shape and dtype), all by ONE gather:
    each shard's parts travel as one byte row. Returns one list of
    every shard's part per value."""
    xs = list(xs)
    if all(x.fully_held for x in xs):
        return [list(x.parts) for x in xs]
    mesh = next(x.mesh for x in xs if not x.fully_held)
    if mesh is None:
        raise RuntimeError("a sharded value with shards of other "
                           "processes needs its mesh to be gathered")
    if len(xs) == 1:
        return [_exchange(mesh, xs[0].parts, kind)]
    metas = [(x.lead.shape, x.lead.dtype) for x in xs]
    packed = [torch.cat([x.parts[d].contiguous().reshape(-1)
                         .view(torch.uint8) for x in xs])
              if mesh.is_local(d) else None for d in range(mesh.size)]
    got = _exchange(mesh, packed, kind)
    out = [list(x.parts) for x in xs]
    for d in range(mesh.size):
        if mesh.is_local(d):
            continue
        at = 0
        for col, (shape, dtype) in zip(out, metas):
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            col[d] = got[d][at:at + n].clone().view(dtype).reshape(shape)
            at += n
    return out


def host_np(x, *more):
    """A program's output → host numpy. A replicated value is its local
    copy; a sharded one is every shard's part stacked (`gather_shards`:
    other processes' parts are gathered over the mesh's group, the
    reference's `process_allgather(tiled=True)`). With `more` values, a
    tuple of each one's, the sharded ones gathered together by one
    gather (`gather_columns`)."""
    if more:
        xs = (x, *more)
        cols = iter(gather_columns([v for v in xs if isinstance(v, Sharded)]))
        return tuple(np.stack([p.cpu().numpy() for p in next(cols)])
                     if isinstance(v, Sharded) else host_np(v) for v in xs)
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
    every operand has the held parts' shape and dtype. A status round
    comes first (the module doc): the payload moves only when every
    rank is ok at this same collective."""
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
    send = send.contiguous()
    recv = [torch.empty_like(send) for _ in mesh.owners]
    # a gather outside every scope opens its own, which needs no
    # closing round: nothing that can fail on one rank follows the gather
    with _scope(mesh, kind, bare=True):
        f = _FRAME.get()
        # nothing between the round and the gather can fail on one rank
        _round(f, kind, shape=[list(send.shape), str(send.dtype)])
        try:
            dist.all_gather(recv, send, group=mesh.group)
        except Exception as e:
            raise _agreed(MeshFailure(
                f"process {mesh.rank}: the {kind} gather did not complete "
                f"within the group's timeout ({group_timeout_s():g} s): "
                f"{e}"), Failure(mesh.rank, "transport", False,
                                 False)) from e
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


# -- the lead's decisions -------------------------------------------------------------

def agree_key(kind: str, *parts) -> str:
    """The key of a decision, `kind/<hash>`: a hash of `parts` (what
    identifies the decision, e.g. a request's lane, text and
    variables), and nothing of what else this process has seen, so
    every rank makes the same key for the same request whatever order
    its threads meet distinct requests in. Identical requests share the
    key and take it in turns (`agree`)."""
    digest = hashlib.sha1(json.dumps(parts, sort_keys=True, default=repr)
                          .encode()).hexdigest()[:24]
    return f"{kind}/{digest}"


@contextlib.contextmanager
def _in_turns(key: str):
    """Hold `key`'s lock (the lead's key, a follower's copy): this
    process's agreements under one key run one at a time. The entry
    lives while some thread uses it."""
    with _occurrence_lock:
        entry = _OCCURRENCES.setdefault(
            key, [locks.make_lock("mesh.agree.key"), 0])
        entry[1] += 1
    try:
        with entry[0]:
            yield
    finally:
        with _occurrence_lock:
            entry[1] -= 1
            if not entry[1]:
                del _OCCURRENCES[key]


def _read_by_all(store, copies: list, key: str) -> None:
    """Wait until every follower has read (and so deleted) the decision
    last published under `key`, at most the group's timeout."""
    limit = time.monotonic() + group_timeout_s()
    pause = 2e-4
    while any(store.check([c]) for c in copies):
        if time.monotonic() > limit:
            raise RuntimeError(
                f"the lead's earlier decision under key {key!r} was not "
                f"read by every follower within the group's timeout "
                f"({group_timeout_s():g} s): every rank must receive the "
                f"requests the lead does")
        time.sleep(pause)
        pause = min(pause * 2, 0.01)


def agree(mesh: Mesh, key: str, decision=None):
    """The lead's `decision` under `key`, the same on every rank of
    `mesh`. The lead (`Mesh.is_lead`) publishes `decision` (a JSON
    value), one copy per follower, and returns it; every other rank
    reads its copy, waiting up to the group's timeout whether it asks
    before or after the lead publishes, then deletes it, and raises
    RuntimeError naming the key when it cannot read it in time: a
    follower never decides for itself. Agreements under one key take
    turns on each rank, and the lead publishes only after every
    follower has deleted its copy of the decision before (the module
    doc), so a key may come again and never reads a stale decision.
    Each call counts once in `CROSS_CALLS["agree"]`. Only for a mesh
    that spans processes: on a mesh of one process nothing is
    agreed."""
    store = _DECISIONS
    if store is None:
        raise RuntimeError(f"no store to agree {key!r} through: a mesh "
                           f"across processes is built after "
                           f"init_distributed")
    if mesh.is_lead:
        copies = [f"{key}@{r}" for r in mesh.owners if r != mesh.rank]
        with _in_turns(key):
            _read_by_all(store, copies, key)
            raw = json.dumps(decision)
            for c in copies:
                store.set(c, raw)
        _count_cross("agree")
        return decision
    mine = f"{key}@{mesh.rank}"
    with _in_turns(mine):
        try:
            raw = store.get(mine)
        except RuntimeError as e:
            raise RuntimeError(
                f"process {mesh.rank}: no decision of the lead under key "
                f"{key!r} within the group's timeout "
                f"({group_timeout_s():g} s); a follower does not decide "
                f"for itself") from e
        store.delete_key(mine)
    _count_cross("agree")
    return json.loads(raw)


@contextlib.contextmanager
def following(promotions: dict):
    """Serve the block under the lead's route promotions (`promoted`):
    the bits the lead granted with the request this thread serves."""
    token = _FOLLOWING.set(dict(promotions))
    try:
        yield
    finally:
        _FOLLOWING.reset(token)


def promoted(mesh: Mesh, route: str, baseline: str) -> bool:
    """Whether the cost priors promote `route` over `baseline` below a
    route's size threshold, for a choice that leads to a mesh program:
    on a mesh of one process this process's route EMAs say
    (`costprior.promoted`); on a mesh that spans processes the lead's
    bit for `route` says, granted with the request this thread serves
    (`following`), and False outside one. A rank's own timings never
    choose a route the other ranks do not take."""
    if not mesh.spans_processes:
        return costprior.promoted(route, baseline)
    bits = _FOLLOWING.get()
    return bool(bits is not None and bits.get(route))


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
