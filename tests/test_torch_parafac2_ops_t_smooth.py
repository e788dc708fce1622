"""Tests of tests/torch_parafac2_ops_cases.py (the tPARAFAC2 prox and its CPU
dispatch): their bodies and helpers are there, unchanged; this file collects
them."""
from torch_parafac2_ops_cases import (  # noqa: F401
    test_torch_t_smoothness_matches_jax,
    test_torch_t_smooth_plan_and_cpu_dispatch)
