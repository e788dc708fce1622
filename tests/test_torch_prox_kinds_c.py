"""Tests of tests/torch_prox_cases.py (make_prox of each kind, the last six,
the TV penalty's sign and custom proxes): their bodies and helpers are
there, unchanged; this file collects them."""
import pytest

from torch_prox_cases import (  # noqa: F401
    test_torch_tv_reg_keeps_the_reference_sign,
    test_torch_custom_prox_takes_torch_functions, KINDS,
    every_prox_and_reg_matches_jax, PROX_IDS)


@pytest.mark.parametrize("kind,params", KINDS[16:22],
                         ids=PROX_IDS[16:22])
def test_torch_every_prox_and_reg_matches_jax(kind, params):
    every_prox_and_reg_matches_jax(kind, params)
