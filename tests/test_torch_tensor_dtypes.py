"""Tests of tests/torch_tensor_cases.py (the kernel's dtype decision): their
bodies and helpers are there, unchanged; this file collects them."""
from torch_tensor_cases import (  # noqa: F401
    test_torch_mttkrp_kernel_dtype_decision)
