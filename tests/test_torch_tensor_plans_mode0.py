"""Tests of tests/torch_tensor_cases.py (the launch plans in mode 0, Khatri-
Rao, ktensor, Grams and the objective): their bodies and helpers are there,
unchanged; this file collects them."""
import pytest

from torch_tensor_cases import (  # noqa: F401
    test_torch_khatri_rao_ktensor_gram_match_jax,
    test_torch_cp_frob_objective_matches_jax, PLAN_SHAPES,
    mttkrp3_plan_covers_every_row)


@pytest.mark.parametrize("shape,R", PLAN_SHAPES)
@pytest.mark.parametrize("mode", [0])
def test_torch_mttkrp3_plan_covers_every_row(shape, R, mode):
    mttkrp3_plan_covers_every_row(shape, R, mode)
