"""Tests of tests/torch_tensor_cases.py (the launch plans in mode 1): their
bodies and helpers are there, unchanged; this file collects them."""
import pytest

from torch_tensor_cases import (  # noqa: F401
    PLAN_SHAPES, mttkrp3_plan_covers_every_row)


@pytest.mark.parametrize("shape,R", PLAN_SHAPES)
@pytest.mark.parametrize("mode", [1])
def test_torch_mttkrp3_plan_covers_every_row(shape, R, mode):
    mttkrp3_plan_covers_every_row(shape, R, mode)
