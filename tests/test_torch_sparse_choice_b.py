"""Tests of tests/torch_sparse_cases.py (the kernel choice, its last seven
cases, and the sparse workload): their bodies and helpers are there,
unchanged; this file collects them."""
import pytest

from torch_sparse_cases import (  # noqa: F401
    test_torch_sparse_workload_is_bench_large, KERNEL_CHOICES,
    sparse_kernel_choice)


@pytest.mark.parametrize("case", KERNEL_CHOICES[7:14],
                         ids=[f"case{i}" for i in range(7, 14)])
def test_torch_sparse_kernel_choice(case):
    sparse_kernel_choice(case)
