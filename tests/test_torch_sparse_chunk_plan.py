"""Tests of tests/torch_sparse_cases.py (the chunk plan, the plan walk and the
wrapper on the CPU): their bodies and helpers are there, unchanged; this
file collects them."""
from torch_sparse_cases import (  # noqa: F401
    test_torch_sparse_chunk_plan_invariants,
    test_torch_sparse_plan_walk_matches_plain,
    test_torch_sparse_wrapper_on_cpu_takes_plain_version,
    test_torch_sparse_tensor_container)
