"""The ELL pull-hop: out[i] = OR_k frontier[nbr[i, k]], by launch table.

Port of `dgraph_tpu/ops/pallas_hop.py:bucket_hop_pallas`. On the card
the hop is the hand-written CUDA kernel in `csrc/bucket_hop.cu` (its
source note says what bounds it and how it is laid out); on the CPU the
same function runs as `bucket_hop_plain`. Which one runs depends only on
where the tensors lie: a CUDA tensor launches the kernel or raises, with
no fallback and no switch.

A hop is a launch table (`HopTable`): one entry per degree bucket — its
slot indices, rows, first output row, the output it writes (the result
or the heavy tail's tile partials) and the body that computes it — plus
entries that set rows to zero, in one or two levels. On the card each
level is ONE launch of the kernel; `bucket_hop` for one bucket is a
one-entry table of the same kernel. The wrapper's checks run once when
a table is built (the index blocks) and once per hop (the masks).

Beyond the reference's hop, a launch can
  * skip empty frontier rows: `flags` [rows] uint8 marks the rows that
    may hold a bit (0 only on an all-zero row); a row flagged 0
    contributes nothing and is never read;
  * write `out_flags` [out rows] uint8 for the rows it writes (1 iff the
    stored row has a bit set), so the next hop can skip them;
  * run the first-visit epilogue of `make_ell_recurse`: with `seen`
    given it stores fresh = nxt & ~seen instead of nxt and ORs fresh into
    `seen` in place (same rows as `out`).

The bodies and their thresholds (`choose_body`): wide rows (wv >= 32
words of the row's vector type) take a warp per row, or a block per row
for at most SPLIT_ROWS rows of K >= SPLIT_K slots, split over blocks of
WIDE_PART_SLOTS slots. Narrow rows (2^lg >= wv lanes a row, G = 32 >> lg
slot groups a warp) take a block per row from GROUP_SLOTS x G slots for
at most NARROW_BLOCK_ROWS rows, split over blocks of GROUP_SLOTS slots
per slot group; else a warp per row or a thread per (row, word),
whichever needs fewer rounds of dependent slot reads once its threads
are spread over RESIDENT_THREADS. The narrow thresholds come from
`tools/hop_bodies.py` on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6
names the runs): there a warp per row beat a thread per row by up to 10x
at 4-4096 rows and lost by up to 3x at 65,536 rows of few slots; a block
per row beat a warp by up to 3x at 4-64 rows from 16 slots a group and
lost at 4096 rows; and the rule's pick was within 1.63x of the fastest
body in all 540 measured buckets.

Lane words are int32 tensors carrying the reference's uint32 bits.
"""

from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from dgraph_tpu_torch.utils import kbuild

# kernel launches by this wrapper (one per table level with rows to
# compute, on a CUDA tensor); chip_smoke.py zeroes it before the main path
# and reads it after
LAUNCHES = {"bucket_hop": 0}
# rows the plain version gathers at once, as [rows, K, W] int32 words
PLAIN_GATHER_BYTES = 64 << 20

# entry bodies, numbered as csrc/bucket_hop.cu numbers them
ZERO, NARROW, NARROW_WARP, NARROW_BLOCK, WARP, SPLIT = range(6)
BODIES = ("zero", "narrow", "narrow_warp", "narrow_block", "warp", "split")
# where an entry writes: the result (with out_flags and seen) or the tile
# partials (with their flags, never seen)
OUT, PARTIALS = 0, 1
# one entry: twelve int64 fields, in the order of the source's `Entry`
FIELDS = ("idx", "n_b", "K", "row0", "dst", "body", "lg", "parts",
          "block0", "blocks", "scratch0", "ticket0")
F = {name: i for i, name in enumerate(FIELDS)}
MAX_ENTRIES = 128             # kMaxEntries in the source
THREADS = 256
WARPS = THREADS // 32
# a grid-stride entry's blocks: at most SMs x 8 (an SM's 2048 threads),
# the cap the per-bucket kernels had before the launch table
BLOCKS_PER_SM = 2048 // THREADS
CPU_SMS = 132                 # the SMs a table built on the CPU assumes

# body rule (the source note, D; narrow thresholds from tools/hop_bodies.py
# on an H100, PERF.md §6)
SPLIT_ROWS = 1024             # wide: a block per row for at most these rows
SPLIT_K = 64                  # ... of at least these slots
WIDE_PART_SLOTS = 4096        # wide: slots per block of a split row
NARROW_BLOCK_ROWS = 1024      # narrow: a block per row for at most these rows
GROUP_SLOTS = 16              # narrow: a block per row from this many slots
                              # per slot group, and at most this many per
                              # slot group in one block of a split row
MAX_BLOCKS = 1 << 20          # block bodies: at most, striding beyond
# threads an H100 holds at once at this kernel's 4 blocks an SM (64
# registers a thread in its int4 form): the narrow rule's one wave
RESIDENT_THREADS = 132 * 4 * THREADS

_fn = None
_sms: dict = {}
# one-bucket tables by (slot-index pointer, shape, row0, width, stream)
_ONE = collections.OrderedDict()
_ONE_MAX = 256


def _kernel():
    global _fn
    if _fn is None:
        lib = kbuild.load("bucket_hop")
        f = lib.dg_bucket_hop
        f.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.dg_error_string.argtypes = [ctypes.c_int]
        lib.dg_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.dg_error_string)
    return _fn


def row_words(W: int, vec4: bool) -> int:
    """A row's words of the kernel's vector type (int4 or int32)."""
    return W // 4 if vec4 else W


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_body(n_b: int, K: int, wv: int) -> tuple:
    """(body, lg, parts) of a bucket of n_b rows of K slots, wv words a
    row: lg is log2 of a narrow row's lanes, parts the blocks a block
    body gives one row. A narrow warp holds G = 32 >> lg slot groups."""
    if wv >= 32:
        if K >= SPLIT_K and n_b <= SPLIT_ROWS:
            return SPLIT, 0, _cdiv(K, WIDE_PART_SLOTS)
        return WARP, 0, 1
    lg = (wv - 1).bit_length()
    G = 32 >> lg
    if K >= GROUP_SLOTS * G and n_b <= NARROW_BLOCK_ROWS:
        return NARROW_BLOCK, lg, _cdiv(K, GROUP_SLOTS * WARPS * G)
    # rounds of four dependent slot reads: a thread per (row, word) walks
    # all K slots, a warp per row K / G, each as many times over as its
    # threads overfill one wave of the card
    R = RESIDENT_THREADS
    if _cdiv(K, 4 * G) * max(R, 32 * n_b) < _cdiv(K, 4) * max(R, n_b << lg):
        return NARROW_WARP, lg, 1
    return NARROW, lg, 1


def _blocks(body: int, n_b: int, lg: int, parts: int, wv: int,
            wave: int) -> int:
    """The blocks an entry owns: a block per (row, part) for the block
    bodies, else what its rows need, at most one wave (they stride)."""
    if body in (NARROW_BLOCK, SPLIT):
        return min(n_b * parts, MAX_BLOCKS)
    if body == ZERO:
        need = _cdiv(n_b * wv, THREADS)
    elif body == NARROW:
        need = _cdiv(_cdiv(n_b, 32 >> lg), WARPS)
    else:
        need = _cdiv(n_b, WARPS)
    return min(need, wave)


@dataclass
class Level:
    """One launch: `rows` is the table as the kernel reads it ([E, 12]
    int64, FIELDS), `idx` each entry's slot-index tensor (None: zero
    rows; the whole list None when the table keeps only pointers),
    `blocks` the grid, `table` the rows on the card (None on the CPU)."""

    rows: np.ndarray
    idx: list | None
    blocks: int
    table: torch.Tensor | None


@dataclass
class HopTable:
    """A hop's launch table at one width: level 1 reads the frontier,
    level 2 (if any) the tile partials level 1 writes. `out_rows`: rows
    of the result it writes ([0, out_rows) at most); `part_rows`: rows of
    the partials (0: none); `src_rows`: rows the frontier must have.
    `scratch` / `tickets`: the split rows' scratch on the card."""

    W: int
    vec4: bool
    levels: list
    out_rows: int
    part_rows: int
    src_rows: int
    scratch: torch.Tensor | None
    tickets: torch.Tensor | None


def _check_index(e, device) -> None:
    if (e.dtype != torch.int32 or e.dim() != 2 or not e.is_contiguous()
            or e.device != device):
        raise ValueError(f"slot indices must be a contiguous 2-D int32 "
                         f"tensor on {device}, got {e.dtype} "
                         f"{tuple(e.shape)} on {e.device}")
    if e.shape[1] < 1 or e.shape[1] >= 2**31:
        raise ValueError(f"a hop bucket needs 1 <= K < 2^31, got "
                         f"{e.shape[1]}")


def _wave(device: torch.device) -> int:
    if device.type != "cuda":
        return CPU_SMS * BLOCKS_PER_SM
    key = device.index
    if key not in _sms:
        _sms[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[key] * BLOCKS_PER_SM


def build_table(levels, W: int, vec4: bool, device, *, out_rows: int,
                part_rows: int = 0, src_rows: int = 0,
                rule=choose_body) -> HopTable:
    """The launch table of `levels`: per level a list of (idx, n_b, row0,
    dst) — idx a [n_b, K] int32 tensor on `device`, or None for n_b rows
    set to zero — at width W (vec4: rows move as int4 words). Checks the
    index blocks and that each entry's rows lie inside its destination
    (`out_rows` result rows, `part_rows` partial rows); entries with no
    rows are dropped. `rule` picks (body, lg, parts) from (n_b, K, wv)."""
    device = torch.device(device)
    wv = row_words(W, vec4)
    wave = _wave(device)
    built = []
    scratch_rows = tickets = 0
    for spec in levels:
        rows, idx = [], []
        block0 = 0
        for e, n_b, row0, dst in spec:
            if n_b == 0:
                continue
            limit = out_rows if dst == OUT else part_rows
            if row0 < 0 or row0 + n_b > limit:
                raise ValueError(f"rows [{row0}, {row0 + n_b}) outside the "
                                 f"destination's {limit} rows")
            if e is None:
                K, (body, lg, parts) = 0, (ZERO, 0, 1)
            else:
                _check_index(e, device)
                if e.shape[0] != n_b:
                    raise ValueError(f"{e.shape[0]} index rows for "
                                     f"{n_b} rows")
                K = int(e.shape[1])
                body, lg, parts = rule(n_b, K, wv)
            blocks = _blocks(body, n_b, lg, parts, wv, wave)
            r = np.zeros(len(FIELDS), np.int64)
            r[[F["idx"], F["n_b"], F["K"], F["row0"], F["dst"], F["body"],
               F["lg"], F["parts"], F["block0"], F["blocks"]]] = [
                e.data_ptr() if e is not None else 0, n_b, K, row0, dst,
                body, lg, parts, block0, blocks]
            if parts > 1:
                r[F["scratch0"]], r[F["ticket0"]] = scratch_rows, tickets
                scratch_rows += n_b * parts
                tickets += n_b
            rows.append(r)
            idx.append(e)
            block0 += blocks
        if not rows:
            continue
        if len(rows) > MAX_ENTRIES:
            raise ValueError(f"{len(rows)} entries in one launch (at most "
                             f"{MAX_ENTRIES})")
        rows = np.stack(rows)
        on_card = (torch.from_numpy(rows).to(device)
                   if device.type == "cuda" else None)
        built.append(Level(rows=rows, idx=idx, blocks=block0,
                           table=on_card))
    scratch = ticket_t = None
    if device.type == "cuda" and tickets:
        scratch = torch.empty(scratch_rows * W, dtype=torch.int32,
                              device=device)
        # tickets start at 0; the last block of each split row resets its own
        ticket_t = torch.zeros(tickets, dtype=torch.int32, device=device)
    return HopTable(W=W, vec4=vec4, levels=built, out_rows=out_rows,
                    part_rows=part_rows, src_rows=src_rows,
                    scratch=scratch, tickets=ticket_t)


def _vec4(frontier, out, seen) -> bool:
    return frontier.shape[1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (frontier, out, seen)
        if t is not None)


def table_key(frontier: torch.Tensor, out: torch.Tensor,
              seen: torch.Tensor | None = None) -> tuple:
    """(W, vec4, stream): what a table is built for. Rows move as int4
    words when W % 4 == 0 and every mask is 16-byte aligned; a table's
    split-row scratch belongs to one stream (launches on it run in
    order)."""
    stream = (torch.cuda.current_stream(frontier.device).cuda_stream
              if frontier.device.type == "cuda" else None)
    return int(frontier.shape[1]), _vec4(frontier, out, seen), stream


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors on one device share a byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def _check_masks(frontier, out, flags, out_flags, seen, out_rows: int,
                 src_rows: int):
    """The masks of one hop (once per hop, whatever its buckets)."""
    dev = frontier.device
    for name, t in (("frontier", frontier), ("out", out), ("seen", seen)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 2
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous 2-D int32 tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for name, t, rows in (("flags", flags, frontier.shape[0]),
                          ("out_flags", out_flags, out.shape[0])):
        if t is not None and (t.dtype != torch.uint8 or t.shape != (rows,)
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous uint8 [{rows}] "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if out.shape[1] != frontier.shape[1]:
        raise ValueError(f"out width {out.shape[1]} != frontier width "
                         f"{frontier.shape[1]}")
    if seen is not None and seen.shape != out.shape:
        raise ValueError(f"seen {tuple(seen.shape)} must match out "
                         f"{tuple(out.shape)}")
    if out.shape[0] < out_rows:
        raise ValueError(f"out has {out.shape[0]} rows, the table writes "
                         f"{out_rows}")
    if frontier.shape[0] < src_rows:
        raise ValueError(f"frontier has {frontier.shape[0]} rows, the "
                         f"table reads {src_rows}")
    # other blocks still gather from the frontier while a launch writes
    # out, seen and out_flags: none of those may share its memory
    for a, b, names in ((frontier, out, "frontier and out"),
                        (frontier, seen, "frontier and seen"),
                        (out, seen, "out and seen"),
                        (flags, out_flags, "flags and out_flags")):
        if a is not None and b is not None and _overlap(a, b):
            raise ValueError(f"{names} share memory")


def _check(nbr, frontier, out, row0, flags, out_flags, seen):
    """One bucket's operands (the plain version's checks)."""
    _check_masks(frontier, out, flags, out_flags, seen, 0, 0)
    if (nbr.dtype != torch.int32 or nbr.dim() != 2
            or not nbr.is_contiguous() or nbr.device != frontier.device):
        raise ValueError(f"nbr must be a contiguous 2-D int32 tensor on "
                         f"{frontier.device}, got {nbr.dtype} "
                         f"{tuple(nbr.shape)} on {nbr.device}")
    n_b, K = nbr.shape
    if K < 1:
        raise ValueError("a hop bucket needs K >= 1")
    if row0 < 0 or row0 + n_b > out.shape[0]:
        raise ValueError(f"rows [{row0}, {row0 + n_b}) outside out's "
                         f"{out.shape[0]} rows")


def _out_for(nbr, frontier, out):
    if out is None:
        out = torch.empty((nbr.shape[0], frontier.shape[1]),
                          dtype=torch.int32, device=frontier.device)
    return out


def bucket_hop_plain(nbr: torch.Tensor, frontier: torch.Tensor,
                     out: torch.Tensor | None = None, row0: int = 0, *,
                     flags: torch.Tensor | None = None,
                     out_flags: torch.Tensor | None = None,
                     seen: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: gather frontier[nbr] (rows flagged 0 as
    zero) and OR-fold over K, then the first-visit epilogue when `seen`
    is given, then the flags of the stored rows. Same contract as
    `bucket_hop`. The gather takes up to PLAIN_GATHER_BYTES of rows at a
    time, as [rows, K, W], and folds K by halving (log2 K ORs)."""
    out = _out_for(nbr, frontier, out)
    _check(nbr, frontier, out, row0, flags, out_flags, seen)
    n_b, K = nbr.shape
    W = frontier.shape[1]
    idx = nbr.long()
    live = flags.bool() if flags is not None else None
    acc = torch.empty((n_b, W), dtype=torch.int32, device=frontier.device)
    step = max(1, PLAIN_GATHER_BYTES // (4 * K * W))
    for r0 in range(0, n_b, step):
        sel = idx[r0:r0 + step]
        rows = frontier[sel]                               # [r, K, W]
        if live is not None:
            rows.masked_fill_(~live[sel][:, :, None], 0)
        # graftlint: allow(hot-loop-checkpoint): O(log K) halving of the
        # bucket's slot axis
        while rows.shape[1] > 1:
            half = rows.shape[1] // 2
            folded = rows[:, :half] | rows[:, half:2 * half]
            if rows.shape[1] % 2:
                folded[:, 0] |= rows[:, -1]
            rows = folded
        acc[r0:r0 + step] = rows[:, 0]
    if seen is not None:
        acc &= ~seen[row0:row0 + n_b]
        seen[row0:row0 + n_b] |= acc
    out[row0:row0 + n_b] = acc
    if out_flags is not None:
        out_flags[row0:row0 + n_b] = acc.ne(0).any(1)
    return out


def _partials(table: HopTable, device):
    if not table.part_rows:
        return None, None
    return (torch.empty((table.part_rows, table.W), dtype=torch.int32,
                        device=device),
            torch.empty(table.part_rows, dtype=torch.uint8, device=device))


def walk_table(table: HopTable, frontier: torch.Tensor, out: torch.Tensor,
               hop=bucket_hop_plain, *, flags=None, out_flags=None,
               seen=None) -> torch.Tensor:
    """The table entry by entry: each bucket through `hop` (a one-bucket
    function of `bucket_hop`'s signature), each zero entry as a torch
    fill. With `bucket_hop_plain` this is the plain version of
    `run_table`."""
    partials, p_flags = _partials(table, frontier.device)
    for li, level in enumerate(table.levels):
        if level.idx is None:
            raise ValueError("a one-bucket table holds pointers only: "
                             "walk the bucket itself")
        src, src_flags = ((frontier, flags) if li == 0
                          else (partials, p_flags))
        for r, e in zip(level.rows, level.idx):
            row0, n_b = int(r[F["row0"]]), int(r[F["n_b"]])
            to_out = r[F["dst"]] == OUT
            dst, dst_flags = ((out, out_flags) if to_out
                              else (partials, p_flags))
            if e is None:
                dst[row0:row0 + n_b].zero_()
                if dst_flags is not None:
                    dst_flags[row0:row0 + n_b].zero_()
            else:
                hop(e, src, dst, row0, flags=src_flags, out_flags=dst_flags,
                    seen=seen if to_out else None)
    return out


def _launch(table: HopTable, frontier, out, flags, out_flags, seen):
    def ptr(t):
        return None if t is None else t.data_ptr()

    partials, p_flags = _partials(table, frontier.device)
    stream = torch.cuda.current_stream(frontier.device).cuda_stream
    fn, err_str = _kernel()
    with torch.cuda.device(frontier.device):
        for li, level in enumerate(table.levels):
            src, src_flags = ((frontier, flags) if li == 0
                              else (partials, p_flags))
            # level 2 only reads the partials: no second pointer to them
            part, part_f = (partials, p_flags) if li == 0 else (None, None)
            rc = fn(level.table.data_ptr(), len(level.rows), level.blocks,
                    src.data_ptr(), ptr(src_flags), table.W,
                    int(table.vec4), out.data_ptr(), ptr(out_flags),
                    ptr(seen), ptr(part), ptr(part_f), ptr(table.scratch),
                    ptr(table.tickets), stream)
            if rc:
                raise RuntimeError(f"bucket_hop launch failed: "
                                   f"{err_str(rc).decode()} (cudaError "
                                   f"{rc})")
            LAUNCHES["bucket_hop"] += 1


def run_table(table: HopTable, frontier: torch.Tensor, out: torch.Tensor, *,
              flags: torch.Tensor | None = None,
              out_flags: torch.Tensor | None = None,
              seen: torch.Tensor | None = None) -> torch.Tensor:
    """One hop by launch table: every entry's rows of `out` (and of
    out_flags, and of seen where fresh has bits), each level one launch
    of the kernel on a CUDA tensor; on the CPU the plain table walk.
    `table` must be built for (frontier, out, seen) (`table_key`). The
    masks are checked here, once per hop. Returns `out`."""
    dev = frontier.device
    _check_masks(frontier, out, flags, out_flags, seen, table.out_rows,
                 table.src_rows)
    if dev.type == "cpu":
        return walk_table(table, frontier, out, flags=flags,
                          out_flags=out_flags, seen=seen)
    if dev.type != "cuda":
        raise ValueError(f"bucket_hop runs on cuda or cpu, not {dev}")
    vec4 = _vec4(frontier, out, seen)
    if (table.W, table.vec4) != (frontier.shape[1], vec4):
        raise ValueError(f"table built for W={table.W} vec4={table.vec4}, "
                         f"called with W={frontier.shape[1]} vec4={vec4}")
    _launch(table, frontier, out, flags, out_flags, seen)
    return out


def one_bucket_table(nbr: torch.Tensor, frontier: torch.Tensor,
                     out: torch.Tensor, row0: int = 0,
                     seen: torch.Tensor | None = None) -> HopTable:
    """The one-entry table of one bucket written at `row0` of `out`,
    cached by everything it holds (the slot-index pointer and shape, the
    row, the width and the stream)."""
    key = (nbr.data_ptr(), tuple(nbr.shape), row0, out.shape[0], str(
        nbr.device)) + table_key(frontier, out, seen)
    tab = _ONE.get(key)
    if tab is not None:
        _ONE.move_to_end(key)
        return tab
    W, vec4, _stream = key[-3:]
    tab = build_table([[(nbr, nbr.shape[0], row0, OUT)]], W, vec4,
                      nbr.device, out_rows=out.shape[0])
    # it keeps the pointer, not the tensor: the caller's nbr lives for
    # the launch
    for level in tab.levels:
        level.idx = None
    _ONE[key] = tab
    if len(_ONE) > _ONE_MAX:
        _ONE.popitem(last=False)
    return tab


def bucket_hop(nbr: torch.Tensor, frontier: torch.Tensor,
               out: torch.Tensor | None = None, row0: int = 0, *,
               flags: torch.Tensor | None = None,
               out_flags: torch.Tensor | None = None,
               seen: torch.Tensor | None = None) -> torch.Tensor:
    """out[row0 + i, :] = OR_k frontier[nbr[i, k], :] for one bucket.

    `nbr` [n_b, K] int32, every entry a row of `frontier` (sentinel rows
    index an all-zero row); `frontier` [rows, W] int32; `out` [*, W]
    int32, allocated as [n_b, W] when None. `flags` [rows] uint8: rows
    flagged 0 are taken as empty and not read. `out_flags` [out rows]
    uint8: written for the bucket's rows. `seen` (shape of `out`): store
    fresh = nxt & ~seen and set seen |= fresh on the bucket's rows. The
    frontier must not share memory with out or seen. Returns `out`. On
    the card one launch of a one-entry table; a bucket with n_b == 0
    launches nothing."""
    out = _out_for(nbr, frontier, out)
    dev = frontier.device
    if dev.type == "cpu":
        return bucket_hop_plain(nbr, frontier, out, row0, flags=flags,
                                out_flags=out_flags, seen=seen)
    if dev.type != "cuda":
        raise ValueError(f"bucket_hop runs on cuda or cpu, not {dev}")
    _check(nbr, frontier, out, row0, flags, out_flags, seen)
    if nbr.shape[0]:
        _launch(one_bucket_table(nbr, frontier, out, row0, seen), frontier,
                out, flags, out_flags, seen)
    return out
