"""Sorted-uid set algebra as fixed-shape torch programs.

Port of `dgraph_tpu/ops/uidalgebra.py`. A *uid set* is a 1-D integer
tensor, sorted ascending, padded at the tail with `sentinel(dtype)` (the
dtype's max value); real uids are strictly smaller. Every op keeps the
reference's static output shapes and overflow contract, so the same
inputs give the same padded outputs on the CPU and on the card.

Two JAX behaviours have no torch equivalent and are written out:
  - `.at[pos].set(..., mode="drop")` scatters into one spare slot past
    the end that is sliced away (an out-of-range index is a device-side
    assert on CUDA and an exception on the CPU);
  - `jnp.take(..., mode="clip")` clamps its indices explicitly.
Nothing here synchronises with the host: counts come back as 0-d tensors.
"""

from __future__ import annotations

import torch

from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

SENTINEL32 = torch.iinfo(torch.int32).max


def sentinel(dtype) -> int:
    """Padding value for a uid dtype: the dtype's maximum."""
    return int(torch.iinfo(dtype).max)


def valid_mask(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the non-padding elements."""
    return a != sentinel(a.dtype)


def count_valid(a: torch.Tensor) -> torch.Tensor:
    """Logical length of a padded sorted uid set (0-d int32)."""
    snt = torch.full((1,), sentinel(a.dtype), dtype=a.dtype, device=a.device)
    return torch.searchsorted(a, snt)[0].to(torch.int32)


def pad_to(a, size: int, device=DEFAULT_DEVICE,
           dtype=torch.int32) -> torch.Tensor:
    """Pad a host array or tensor to `size` with the sentinel, on
    `device` (one host-to-device copy of the padded array)."""
    dev = resolve_device(device)
    a = torch.as_tensor(a).to(dtype)
    n = a.shape[0]
    if n > size:
        raise ValueError(f"uid set of length {n} exceeds capacity {size}")
    out = torch.full((size,), sentinel(dtype), dtype=dtype)
    out[:n] = a.cpu()
    return out.to(dev)


def compact_with_count(values: torch.Tensor, keep: torch.Tensor, size: int):
    """Stably move `values[keep]` to the front of a sentinel-padded
    [size] tensor → (out, kept), `kept` the TRUE number of kept elements.
    `kept > size` means the tail beyond `size` was dropped and the caller
    must re-run with a bigger bucket."""
    snt = sentinel(values.dtype)
    k = keep.to(torch.int32)
    kept = k.sum(dtype=torch.int32)
    pos = torch.cumsum(k, 0, dtype=torch.int64) - 1
    # dropped elements (not kept, or past `size`) land in the spare slot
    pos = torch.where(keep, pos, size).clamp_(max=size)
    out = torch.full((size + 1,), snt, dtype=values.dtype,
                     device=values.device)
    out.scatter_(0, pos, values)
    return out[:size], kept


def compact(values: torch.Tensor, keep: torch.Tensor,
            size: int) -> torch.Tensor:
    """`compact_with_count` without the count, for callers whose `size`
    provably cannot overflow."""
    return compact_with_count(values, keep, size)[0]


def _member(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """For each element of `a`, whether it occurs in sorted padded `b`."""
    idx = torch.searchsorted(b, a).clamp_(max=b.shape[0] - 1)
    return (b[idx] == a) & valid_mask(a)


def intersect_sorted(a: torch.Tensor, b: torch.Tensor,
                     size: int | None = None) -> torch.Tensor:
    """a ∩ b for sorted padded uid sets."""
    if size is None:
        size = a.shape[0]
    return compact(a, _member(a, b), size)


def difference_sorted(a: torch.Tensor, b: torch.Tensor,
                      size: int | None = None) -> torch.Tensor:
    """a \\ b for sorted padded uid sets."""
    if size is None:
        size = a.shape[0]
    return compact(a, valid_mask(a) & ~_member(a, b), size)


def sort_unique_count(x: torch.Tensor, size: int):
    """Sort an arbitrary padded tensor, drop duplicates and padding →
    (out[size], n_unique); `n_unique > size` means truncated."""
    s = torch.sort(x).values
    first = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    return compact_with_count(s, valid_mask(s) & first, size)


def sort_unique(x: torch.Tensor, size: int) -> torch.Tensor:
    """`sort_unique_count` without the count; only safe when
    `size >= x.shape[0]`."""
    return sort_unique_count(x, size)[0]


def merge_sorted(a: torch.Tensor, b: torch.Tensor,
                 size: int | None = None) -> torch.Tensor:
    """Deduplicating union of two sorted padded uid sets."""
    if size is None:
        size = a.shape[0] + b.shape[0]
    return sort_unique(torch.cat([a, b]), size)


def index_of(a: torch.Tensor, v) -> torch.Tensor:
    """Position of uid `v` in sorted padded `a`, or -1 (0-d int32)."""
    v = torch.as_tensor(v, dtype=a.dtype, device=a.device).reshape(1)
    idx = torch.searchsorted(a, v).clamp_(max=a.shape[0] - 1)
    return torch.where(a[idx] == v, idx.to(torch.int32),
                       torch.tensor(-1, dtype=torch.int32,
                                    device=a.device))[0]


def contains(a: torch.Tensor, v) -> torch.Tensor:
    """Whether sorted padded `a` contains uid `v` (0-d bool)."""
    return index_of(a, v) >= 0


def take_page(a: torch.Tensor, offset, first, size: int) -> torch.Tensor:
    """Pagination window over a sorted padded uid set: skip `offset`,
    keep `first` (negative: the last |first|; 0: all). The output keeps
    `a`'s length; `size` is kept for the reference's signature."""
    del size
    n = count_valid(a)
    offset = torch.as_tensor(offset, dtype=torch.int32, device=a.device)
    first = torch.as_tensor(first, dtype=torch.int32, device=a.device)
    start = torch.where(first < 0, torch.clamp(n + first - offset, min=0),
                        offset)
    cnt = torch.where(first < 0, torch.minimum(-first, n - start),
                      torch.where(first == 0, n - start,
                                  torch.minimum(first, n - start)))
    cnt = torch.clamp(cnt, min=0)
    i = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    src = torch.clamp(i + start, max=a.shape[0] - 1).long()
    return torch.where(i < cnt, a[src],
                       torch.tensor(sentinel(a.dtype), dtype=a.dtype,
                                    device=a.device))
