"""Tests of tests/torch_admm_cases.py (the precompute, the inner loops, the
small solves and the objective): their bodies and helpers are there,
unchanged; this file collects them."""
from torch_admm_cases import (  # noqa: F401
    test_torch_cp_mode_precompute_matches_jax,
    test_torch_admm_constrained_only_matches_jax,
    test_torch_admm_coupled_type4_matches_jax,
    test_torch_cholesky_of_non_pd_flags_and_does_not_raise,
    test_torch_small_solves_match_jax,
    test_torch_func_eval_matches_jax_fresh_and_cached)
