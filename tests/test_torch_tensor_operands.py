"""Tests of tests/torch_tensor_cases.py (the kernel's operands): their bodies
and helpers are there, unchanged; this file collects them."""
from torch_tensor_cases import (  # noqa: F401
    test_torch_mttkrp3_kernel_operands)
