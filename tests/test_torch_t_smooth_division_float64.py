"""Tests of tests/torch_t_smooth_division_cases.py (the float64 division step,
the exhaustive small precision and the guard): their bodies and helpers are
there, unchanged; this file collects them."""
from torch_t_smooth_division_cases import (  # noqa: F401
    test_torch_t_smooth_correction_float64_is_ieee_division,
    test_torch_t_smooth_correction_small_precision_exhaustive,
    test_torch_t_smooth_guard_excludes_what_the_correction_cannot_hold)
