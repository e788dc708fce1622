"""Tests of tests/torch_t_smooth_division_cases.py (the float32 division step):
their bodies and helpers are there, unchanged; this file collects them."""
from torch_t_smooth_division_cases import (  # noqa: F401
    test_torch_t_smooth_correction_float32_is_ieee_division)
