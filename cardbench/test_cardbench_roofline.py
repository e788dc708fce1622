"""The roofline counts against hand counts."""
import types

import pytest

from cardbench import roofline


def test_dense_hand_count():
    # 4 x 5 x 6 float32 at R 3 for 2 starts: X 120 * 4 bytes once; per
    # start the two gathered factors and the output, (5 + 6 + 4) rows of 3
    for mode in range(3):
        assert roofline.dense_mttkrp((4, 5, 6), mode, 3, starts=2) == (
            480 + 2 * 3 * 4 * 15, 2 * 120 * 3 * 2)


def test_products_follow_the_starts_still_stepping():
    assert roofline.mttkrp_products(3, 2, [2, 1]) == [
        (0, 2), (0, 2), (1, 2), (2, 2), (0, 1), (1, 1), (2, 1)]
    assert roofline.mttkrp_products(2, 1, [1]) == [(0, 1), (0, 1), (1, 1)]


def test_job_bound_counts_only_3way_data():
    dense = {"shape": (4, 5, 6), "rank": 3}
    matrix = {"shape": (4, 5), "rank": 3}
    job = types.SimpleNamespace(n_starts=1, stop_iters=[1])
    one = roofline.bound_seconds(*roofline.dense_mttkrp((4, 5, 6), 0, 3))
    assert roofline.job_bound_seconds([dense, matrix], [job]) == (
        pytest.approx(4 * one))


def test_job_operations_hand_count():
    # 2 starts, one stepping twice and one once: the 3-way dataset's
    # products are 1 + 3 + 3 mode products of 2, 2, 1 starts at 2 * 120 * 3
    # operations a start; the matrix's 1 + 2 + 2 of 2 * 20 * 3
    dense = {"shape": (4, 5, 6), "rank": 3}
    matrix = {"shape": (4, 5), "rank": 3}
    job = types.SimpleNamespace(n_starts=2, stop_iters=[2, 1])
    assert roofline.job_operations([dense, matrix], [job]) == (
        720 * (2 + 3 * 2 + 3 * 1) + 120 * (2 + 2 * 2 + 2 * 1))


def test_bound_is_the_larger_side():
    assert roofline.bound_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_seconds(0, 67e12) == pytest.approx(1.0)
