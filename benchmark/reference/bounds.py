"""Least times: the work an input needs, over the chip's peaks.

`hop_bound` is `chip_smoke.py`'s `hop_bound`, frozen here, with one
change: the index bytes are the graph's real edges (4 B each, read
once), not the padded slots of the program's layout."""

from __future__ import annotations

from benchmark.reference.peaks import ALU_OPS_PER_S, HBM_BYTES_PER_S


def hop_bound(n: int, nnz: int, W: int, occupied_rows: int, nxt_rows: int,
              fresh_rows: int, occupied_slots: int) -> dict:
    """The least seconds one fused first-visit hop over `W` 32-bit lane
    words could take: every edge index once, each occupied frontier row
    once, the frontier's and the result's row flags, seen read where the
    OR has bits, the fresh mask written whole, seen written where fresh
    has bits, over the HBM rate; one OR per occupied edge and lane word
    over the ALU rate. The larger of the two."""
    row = 4 * W
    nbytes = (4 * nnz + occupied_rows * row + 2 * (n + 1)
              + nxt_rows * row + (n + 1) * row + fresh_rows * row)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = occupied_slots * W / ALU_OPS_PER_S
    return {"bound_s": max(bytes_s, ops_s), "bytes": nbytes,
            "bytes_s": bytes_s, "ops_s": ops_s,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def knn_scan_bound(rows: int, dim: int) -> dict:
    """The least seconds of one brute-force k-NN scan of a [rows, dim]
    float32 tablet: every component read once (the query and the k
    results are a rounding error beside it); the dot products' 2·rows·dim
    operations at the float32 rate are far below."""
    from benchmark.reference.peaks import FP32_FLOP_PER_S
    nbytes = rows * dim * 4
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = 2 * rows * dim / FP32_FLOP_PER_S
    return {"bound_s": max(bytes_s, ops_s), "bytes": nbytes,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
