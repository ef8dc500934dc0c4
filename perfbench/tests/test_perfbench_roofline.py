"""The roofline counts against shapes worked by hand."""

import numpy as np
import pytest

from perfbench import peaks
from perfbench.registry import Registry


def test_scan_count_by_hand():
    scan = Registry().roofline("scan")
    # Q=2, N=3 rows of d=4 f32, k=1: 2*2*3*4 = 48 operations;
    # rows 3*(16+1) = 51 B, queries 2*16 = 32 B, hits 2*1*8 = 16 B
    assert scan.count(2, 3, 4, 1, 4) == (48.0, 99)


def test_scan_count_at_the_cell():
    scan = Registry().roofline("scan")
    ops, nbytes = scan.count(256, 1_000_000, 512, 10, 4)
    assert ops == 2 * 256 * 1_000_000 * 512
    assert nbytes == 1_000_000 * 2049 + 256 * 2048 + 256 * 80
    # bytes bound the f32 scan at b256: 0.6118 ms against 0.5296 ms of ops
    assert peaks.bound_s(ops, nbytes, "float32") == pytest.approx(
        nbytes / 3.35e12)


def test_ivf_probe_count_by_hand():
    probe = Registry().roofline("ivf_probe")
    cell_rows = np.array([5, 0, 7, 2])
    cells = np.array([[0, 2], [2, 3]])  # query 0: 5+7 rows, query 1: 7+2
    ops, nbytes = probe.count(cells, cell_rows, spill_rows=1, d=4, k=2,
                              element_bytes=4)
    # scored: 12 + 9 + 2 spill = 23 rows -> 2*4*23 = 184 operations
    assert ops == 184.0
    # read once: cells {0,2,3} = 14 rows + 1 spill = 15 rows of 17 B,
    # queries 2*16 B, hits 2*2*8 B
    assert nbytes == 15 * 17 + 32 + 32


def test_ivf_probe_picks_nearest_centroids():
    probe = Registry().roofline("ivf_probe")
    cents = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]], np.float32)
    q = np.array([[9.0, 1.0], [1.0, 8.0]], np.float32)
    picked = probe.picked_cells(q, cents, 2)
    assert set(picked[0]) == {1, 0} and set(picked[1]) == {2, 0}


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(495e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 1.0, "bfloat16") == pytest.approx(1.0)
