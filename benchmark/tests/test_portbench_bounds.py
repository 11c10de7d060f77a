import pytest

from benchmark.reference import bounds, peaks


def test_hop_bound_counts_each_byte_once():
    # n = 9 rows, 20 edges, W = 2 words (8-byte rows): indices 80 B,
    # 3 occupied rows 24 B, flags 2 * 10 B, seen read on 4 rows 32 B,
    # fresh written whole 80 B, seen written on 2 rows 16 B
    b = bounds.hop_bound(9, 20, 2, occupied_rows=3, nxt_rows=4,
                         fresh_rows=2, occupied_slots=7)
    assert b["bytes"] == 80 + 24 + 20 + 32 + 80 + 16
    assert b["bytes_s"] == pytest.approx(252 / peaks.HBM_BYTES_PER_S)
    assert b["ops_s"] == pytest.approx(14 / peaks.ALU_OPS_PER_S)
    assert b["bound_by"] == "bytes" and b["bound_s"] == b["bytes_s"]


def test_hop_bound_of_the_bench_shape():
    n, W = 1 << 20, 128
    b = bounds.hop_bound(n, 33_000_000, W, occupied_rows=n, nxt_rows=n,
                         fresh_rows=0, occupied_slots=33_000_000)
    row = 512
    want = 4 * 33_000_000 + n * row + 2 * (n + 1) + n * row + (n + 1) * row
    assert b["bytes"] == want
    assert b["ops_s"] == pytest.approx(33_000_000 * W / 67e12)


def test_knn_scan_bound_reads_the_tablet_once():
    b = bounds.knn_scan_bound(1_009_892, 384)
    assert b["bytes"] == 1_009_892 * 384 * 4 == 1_551_194_112
    assert b["bound_s"] == pytest.approx(1_551_194_112 / 3.35e12)
    assert b["bound_by"] == "bytes"
