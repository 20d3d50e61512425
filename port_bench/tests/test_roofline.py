"""The kernels' least time, worked by hand."""

from __future__ import annotations

import pytest

from port_bench import roofline


def test_nn1_pairs_and_bytes():
    # two streams, 1,000 queries each, 300 and 500 valid target rows
    pairs, n_bytes = roofline.launch_work("nn1", [300, 500], 1000, 1)
    assert pairs == 1000 * 300 + 1000 * 500
    assert n_bytes == (13 * 300 + 20 * 1000 + 64) + (13 * 500 + 20 * 1000 + 64)


def test_self_knn_pairs_and_bytes():
    pairs, n_bytes = roofline.launch_work("knn_k", [4, 10], 5000, 16)
    assert pairs == 16 + 100  # valid rows against valid rows, not the padded 5,000
    assert n_bytes == (13 + 12 + 8 * 16) * 4 + (13 + 12 + 8 * 16) * 10


def test_least_time_is_the_larger_bound():
    ops_bound = roofline.least_time(10**9, 1)
    assert ops_bound == pytest.approx(9e9 / 33.5e12)
    bytes_bound = roofline.least_time(1, 3.35e9)
    assert bytes_bound == pytest.approx(1e-3)


def test_least_seconds_sums_launches_by_kind():
    launches = [("nn1", [100], 10, 1), ("nn1", [100], 10, 1), ("knn_k", [50], 50, 10)]
    got = roofline.least_seconds(launches)
    one = roofline.least_time(*roofline.launch_work("nn1", [100], 10, 1))
    assert got["nn1"] == pytest.approx(2 * one)
    assert got["knn_k"] == pytest.approx(roofline.least_time(*roofline.launch_work("knn_k", [50], 50, 10)))


def test_share_reads_nothing_from_nothing():
    assert roofline.share_pct(None, 1.0) is None
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(0.5, 2.0) == pytest.approx(25.0)
