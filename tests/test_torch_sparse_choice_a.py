"""Tests of tests/torch_sparse_cases.py (the kernel choice, its first seven
cases, and the plans on the CPU): their bodies and helpers are there,
unchanged; this file collects them."""
import pytest

from torch_sparse_cases import (  # noqa: F401
    test_torch_sparse_plans_and_devices_on_the_cpu, KERNEL_CHOICES,
    sparse_kernel_choice)


@pytest.mark.parametrize("case", KERNEL_CHOICES[0:7],
                         ids=[f"case{i}" for i in range(0, 7)])
def test_torch_sparse_kernel_choice(case):
    sparse_kernel_choice(case)
