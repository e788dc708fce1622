"""Tests of tests/torch_prox_cases.py (the kinds ported, the quadratic
operators' dtype and the constraint specs): their bodies and helpers are
there, unchanged; this file collects them."""
from torch_prox_cases import (  # noqa: F401
    test_torch_every_known_kind_is_ported_or_names_its_slice,
    test_torch_quadratic_operators_take_the_data_dtype,
    test_torch_constraint_specs_cross_from_the_jax_package)
