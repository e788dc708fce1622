"""Tests of tests/torch_sparse_cases.py (the fiber walk in modes 0 and 1, the
input rules and the fit against the JAX fit): their bodies and helpers are
there, unchanged; this file collects them."""
import pytest

from torch_sparse_cases import (  # noqa: F401
    test_torch_check_data_input_refuses_sparse_kl_and_miss,
    test_torch_sparse_fit_matches_jax, FIBER_WALK_RS,
    sparse_fiber_walk_matches_plain)


@pytest.mark.parametrize("R", FIBER_WALK_RS)
@pytest.mark.parametrize("mode", [0, 1])
def test_torch_sparse_fiber_walk_matches_plain(mode, R):
    sparse_fiber_walk_matches_plain(mode, R)
