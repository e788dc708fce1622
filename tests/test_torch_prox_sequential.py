"""Tests of tests/torch_prox_cases.py (the plain sequential proxes and the
kernel wrappers on the CPU): their bodies and helpers are there, unchanged;
this file collects them."""
from torch_prox_cases import (  # noqa: F401
    test_torch_plain_sequential_proxes_match_jax,
    test_torch_plain_sequential_proxes_match_native,
    test_torch_sequential_proxes_keep_dtype_and_count_steps,
    test_torch_kernel_wrappers_refuse_cpu_tensors)
