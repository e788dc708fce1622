"""Tests of tests/torch_tensor_cases.py (the CPU dispatch and the stream plan's
walk): their bodies and helpers are there, unchanged; this file collects
them."""
from torch_tensor_cases import (  # noqa: F401
    test_torch_mttkrp3_cpu_takes_plain_version,
    test_torch_mttkrp3_stream_walk_matches_jax)
