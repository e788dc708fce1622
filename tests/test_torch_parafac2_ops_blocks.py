"""Tests of tests/torch_parafac2_ops_cases.py (the precomputes, polar factors,
batched solvers and Parafac2Tensor): their bodies and helpers are there,
unchanged; this file collects them."""
from torch_parafac2_ops_cases import (  # noqa: F401
    test_torch_par2_precomputes_match_jax,
    test_torch_polar_and_newton_match_jax,
    test_torch_batched_spd_solvers_match_jax,
    test_torch_parafac2_tensor_crosses_from_jax,
    test_torch_parafac2_tensor_from_list_defaults_to_the_card)
