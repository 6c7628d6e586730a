"""The roofline's counts from shapes."""

import pytest

from isingbench import roofline


def test_counts_at_the_cells_shape():
    rows = cols = 65536
    sites = rows * cols // 2
    assert roofline.bit1_phase_sites(rows, cols) == 2**31
    # each color plane is sites / 32 words of 4 bytes: dst read and
    # written, src read
    assert roofline.bit1_phase_bytes(rows, cols) == 3 * (sites // 32) * 4
    assert roofline.bit1_phase_ops(rows, cols, "philox") == \
        sites * (10 + 2 + 14 / 32)
    assert roofline.bit1_phase_ops(rows, cols, "philox7") == \
        sites * (7 + 2 + 14 / 32)


def test_bound_takes_the_larger_and_names_it():
    peak = roofline.H100
    rate = peak["sms"] * peak["ops_per_sm_clock"] * peak["clock_hz"]
    t, which = roofline.bound_s(rate, 1.0)
    assert which == "operations" and t == pytest.approx(1.0)
    t, which = roofline.bound_s(1.0, peak["hbm_bytes_per_s"] * 2)
    assert which == "bytes" and t == pytest.approx(2.0)


def test_operations_bind_the_philox_phase():
    t, which = roofline.bit1_phase_bound_s(65536, 65536, "philox")
    assert which == "operations"
    assert t == pytest.approx(2**31 * 12.4375 / (132 * 128 * 1.98e9))
    # a slab's launch is bounded by its own rows
    assert roofline.bit1_phase_bound_s(65536, 65536, "philox")[0] == \
        pytest.approx(roofline.bit1_phase_bound_s(131072, 65536,
                                                  "philox")[0] / 2)


def test_unknown_mode_has_no_count():
    with pytest.raises(ValueError):
        roofline.bit1_phase_ops(64, 64, "chacha6b")
