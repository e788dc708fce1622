"""Tests of tests/torch_tensor_cases.py (the column blocks of R past 32): their
bodies and helpers are there, unchanged; this file collects them."""
from torch_tensor_cases import test_torch_mttkrp3_column_blocks  # noqa: F401
