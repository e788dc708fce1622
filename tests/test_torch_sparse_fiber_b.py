"""Tests of tests/torch_sparse_cases.py (the fiber walk in mode 2, the golden,
the dense fit and nvecs): their bodies and helpers are there, unchanged;
this file collects them."""
import pytest

from torch_sparse_cases import (  # noqa: F401
    test_torch_sparse_fit_reproduces_golden,
    test_torch_sparse_fit_matches_dense_fit,
    test_torch_nvecs_init_matches_jax, FIBER_WALK_RS,
    sparse_fiber_walk_matches_plain)


@pytest.mark.parametrize("R", FIBER_WALK_RS)
@pytest.mark.parametrize("mode", [2])
def test_torch_sparse_fiber_walk_matches_plain(mode, R):
    sparse_fiber_walk_matches_plain(mode, R)
