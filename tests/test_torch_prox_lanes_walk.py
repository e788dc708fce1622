"""Tests of tests/torch_prox_lanes_cases.py (the lanes walk and fill): their
bodies and helpers are there, unchanged; this file collects them."""
from torch_prox_lanes_cases import (  # noqa: F401
    test_torch_lanes_walk_and_fill_match_the_plain_walk)
