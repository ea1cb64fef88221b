"""The DP's work, counted from the recurrence, against what the kernel's
source counts (19 operations a band cell with directions, 14 without)
and the bound of the smoke run's launch (2048 pairs of 10 kbp at W 256,
2,881,620,959 band cells: 1.6343 ms at 19 operations a cell)."""

import pytest

from harness import core, peaks

SOURCE_OPS = {True: 19, False: 14}
SMOKE_CELLS = 2_881_620_959


def test_recurrence_counts_against_the_kernels_source():
    counts = core.load("counts", "dp_ad")
    assert counts.OPS_PER_CELL == {False: 11, True: 17}
    # the recurrence needs no more than the kernel's source does; the
    # difference is the kernel's own bookkeeping (masks, drift)
    for dirs in (False, True):
        assert counts.OPS_PER_CELL[dirs] <= SOURCE_OPS[dirs]
    assert (counts.OPS_PER_CELL[True] - counts.OPS_PER_CELL[False]
            == 6)


def test_smoke_launch_bound():
    # the peaks reproduce the bound the smoke run reported
    assert peaks.bound_s(0, SOURCE_OPS[True] * SMOKE_CELLS) * 1e3 == \
        pytest.approx(1.6343, abs=1e-4)
    counts = core.load("counts", "dp_ad")
    rows = [(SMOKE_CELLS // 2048, 10_600, 10_600)] * 2048
    ops, nbytes = counts.work(rows, True)
    assert ops == 17 * (SMOKE_CELLS // 2048) * 2048
    # the nibble plane, codes and ends: 1.5 GB, bound by operations
    assert nbytes == pytest.approx(SMOKE_CELLS / 2 + 2048 * (21_200 + 12),
                                   rel=1e-6)
    assert peaks.bound_s(nbytes, ops) == ops / peaks.FP32_OPS_PER_S
    ops0, nbytes0 = counts.work(rows, False)
    assert ops0 == 11 * (SMOKE_CELLS // 2048) * 2048
    assert nbytes0 == 2048 * (21_200 + 4)
