"""Tests of tests/torch_admm_cases.py (the proxes, the parts not ported and the
matmul precision): their bodies and helpers are there, unchanged; this file
collects them."""
from torch_admm_cases import (  # noqa: F401
    test_torch_prox_matches_jax,
    test_torch_unported_parts_raise_not_implemented,
    test_torch_matmul_precision_sets_both_tf32_switches)
