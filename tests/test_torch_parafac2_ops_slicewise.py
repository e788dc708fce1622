"""Tests of tests/torch_parafac2_ops_cases.py (the slice-wise proxes): their
bodies and helpers are there, unchanged; this file collects them."""
from torch_parafac2_ops_cases import (  # noqa: F401
    test_torch_prox_slicewise_matches_jax)
