"""Tests of tests/torch_tensor_cases.py (the rows-stream plan's walk in mode
1): their bodies and helpers are there, unchanged; this file collects them."""
import pytest

from torch_tensor_cases import (  # noqa: F401
    ROWS_WALK_CASES, mttkrp3_rows_walk_matches_jax)


@pytest.mark.parametrize("shape,R,sms", ROWS_WALK_CASES)
@pytest.mark.parametrize("mode", [1])
def test_torch_mttkrp3_rows_walk_matches_jax(shape, R, sms, mode):
    mttkrp3_rows_walk_matches_jax(shape, R, sms, mode)
