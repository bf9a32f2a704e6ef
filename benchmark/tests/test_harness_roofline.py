"""The least time of an EM iteration, against the hand computation."""

import pytest
import roofline


def test_twenty_newsgroups_counts():
    nnz, n, m, k = 2_711_701, 18_846, 25_000, 20
    assert roofline.em_step_bytes(nnz, n, m, k) == 8 * nnz + (n + m) * k * 8
    assert roofline.em_step_bytes(nnz, n, m, k) == pytest.approx(21.69e6 + 7.02e6, rel=1e-3)
    assert roofline.em_step_flop(nnz, k) == pytest.approx(325.4e6, rel=1e-3)
    # bytes bound: 28.7 MB / 3.35 TB/s = 8.57 us; operations: 4.86 us
    assert roofline.em_step_least_s(nnz, n, m, k) == pytest.approx(8.57e-6, rel=2e-3)


def test_nytimes_counts():
    nnz, n, m, k = 69_679_427, 300_000, 102_660, 20
    assert roofline.em_step_bytes(nnz, n, m, k) == pytest.approx(557.4e6 + 64.4e6, rel=1e-3)
    assert roofline.em_step_flop(nnz, k) / 67e12 == pytest.approx(124.8e-6, rel=1e-3)
    assert roofline.em_step_least_s(nnz, n, m, k) == pytest.approx(185.6e-6, rel=1e-3)


def test_operation_bound_where_topics_are_many():
    # at k = 1000 the operations outweigh the bytes: 6 * nnz * k / 67e12
    assert roofline.em_step_least_s(10**6, 10, 10, 1000) == pytest.approx(6e9 / 67e12)
