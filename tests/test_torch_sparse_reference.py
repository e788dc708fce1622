"""Tests of tests/torch_sparse_cases.py (the plain sparse MTTKRP and the fiber
plan): their bodies and helpers are there, unchanged; this file collects
them."""
from torch_sparse_cases import (  # noqa: F401
    test_torch_sparse_reference_matches_jax,
    test_torch_sparse_reference_matches_dense_mttkrp,
    test_torch_sparse_plan_invariants,
    test_torch_sparse_build_plan_variants)
