"""The controls: the reference put in the program's place in the
precision below the configuration's must come out as not correct."""

import pytest

from benchmark import control
from benchmark.tests.conftest import TINY


def test_the_tf32_control_fails_the_rag_cell_at_a_test_size():
    for r in control.readings("snb-sf1-rag.knn-c8", [3, 2 ** 31 + 7], 120,
                              "cpu", TINY["snb-sf1-rag.knn-c8"]):
        assert r["fails"], r
        assert r["mean_err"] > 10 * r["limits"]["mean_err"]


def test_the_traversal_control_reads_no_fault_where_counts_are_small():
    # below 2^24 a float32 sum of integer degrees is exact: the control
    # can only fail at the cell's size (the card test below)
    r, = control.readings("graph500-s20.recurse4-l4096", [5], 3, "cpu",
                          TINY["graph500-s20.recurse4-l4096"])
    assert r["lanes_off"] == 0 and r["max_count"] < 2 ** 24


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2147483659, 3000000019])
def test_the_float32_control_fails_the_traversal_cell(card, seed):
    r, = control.readings("graph500-s20.recurse4-l4096", [seed], 70, card)
    assert r["max_count"] > 2 ** 24 and r["fails"] == ["lanes_off"], r


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [13, 2147483693, 3000000037])
def test_the_tf32_control_fails_the_rag_cell(card, seed):
    r, = control.readings("snb-sf1-rag.knn-c8", [seed], 4000, card)
    assert {"knn_gap", "mean_err"} <= set(r["fails"]), r
