"""Tests of tests/torch_prox_cases.py (make_prox of each kind, the next eight):
their bodies and helpers are there, unchanged; this file collects them."""
import pytest

from torch_prox_cases import (  # noqa: F401
    KINDS, every_prox_and_reg_matches_jax, PROX_IDS)


@pytest.mark.parametrize("kind,params", KINDS[8:16],
                         ids=PROX_IDS[8:16])
def test_torch_every_prox_and_reg_matches_jax(kind, params):
    every_prox_and_reg_matches_jax(kind, params)
