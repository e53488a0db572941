"""The frozen sweep bound, pinned at the cells' 256^3 grid."""
import pytest

from benchmark import roofline_frozen as rf


def test_frozen_peaks():
    assert rf.PEAK_FP32 == 67e12 and rf.PEAK_BYTES == 3.35e12


def test_sweep_counts_at_256():
    cells = 256 ** 3
    assert 6 * rf.sweep_flops(cells) == 97_844_723_712
    # 16 B of state read and written per cell, 20 481 records of 80 B.
    assert 6 * rf.sweep_bytes(cells, 20_481) == 3_231_056_352


def test_sweep_bound_at_256_is_the_operations():
    bound = rf.sweep_bound_s(256 ** 3, 20_480)
    assert bound == pytest.approx(97_844_723_712 / 67e12)
    assert bound == pytest.approx(1.46037e-3, rel=1e-5)


def test_sweep_bound_takes_bytes_when_records_dominate():
    # Few cells, many triangles: the records' bytes bound the sweep.
    bound = rf.sweep_bound_s(1000, 10_000_000)
    assert bound == pytest.approx(6 * rf.sweep_bytes(1000, 10_000_001)
                                  / 3.35e12)
