"""Tests of tests/torch_tensor_cases.py (the plans' refusals): their bodies and
helpers are there, unchanged; this file collects them."""
from torch_tensor_cases import test_torch_mttkrp3_plan_rejects  # noqa: F401
