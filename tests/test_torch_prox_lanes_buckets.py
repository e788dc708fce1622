"""Tests of tests/torch_prox_lanes_cases.py (the ragged form against the port's
buckets): their bodies and helpers are there, unchanged; this file collects
them."""
from torch_prox_lanes_cases import (  # noqa: F401
    test_torch_ragged_form_is_the_buckets_bit_for_bit)
