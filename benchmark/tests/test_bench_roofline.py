"""The yardstick's counts on hand-counted pairs."""

import pytest

from benchmark import roofline


def test_banded_cells_on_hand_counted_pairs():
    # one cell
    assert roofline.banded_cells([1], [1], [1], 751) == 1
    # 3 x 2, wide band, every diagonal: all 6 cells
    assert roofline.banded_cells([3], [2], [4], 751) == 6
    # a band of 0 keeps the main diagonal: 3 cells of 3 x 3 over its
    # 5 diagonals (the off-diagonal ones hold none)
    assert roofline.banded_cells([3], [3], [5], 0) == 3
    # a band of 1 on 3 x 3: the diagonal and its two neighbours, 7 cells
    assert roofline.banded_cells([3], [3], [5], 1) == 7
    # a Z-drop exit after 2 diagonals of a 3 x 3: cells (0,0), (0,1), (1,0)
    assert roofline.banded_cells([3], [3], [2], 751) == 3
    # swept past the matrix (the sweep's wrap-up): nothing more
    assert roofline.banded_cells([3], [2], [20], 751) == 6
    assert roofline.banded_cells([3, 1], [2, 1], [4, 1], 751) == 7


def test_least_time_takes_the_longer_of_operations_and_bytes():
    cells = 10**9
    ops_s = 12 * cells / roofline.INT32_OPS_PER_S
    assert roofline.score_least(cells, [10], [10]) == pytest.approx(ops_s)
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    # no cells: the bytes bound, 4-bit codes, lengths, four results
    b = (5 + 5 + 8 + 16) / roofline.HBM_BYTES_PER_S
    assert roofline.score_least(0, [10], [9]) == pytest.approx(b)
    tb = (20 * cells + 10 * 1000) / roofline.INT32_OPS_PER_S
    assert roofline.traceback_least(cells, 1000, [10], [10]) == \
        pytest.approx(tb)
