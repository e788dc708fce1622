"""Tests of tests/torch_prox_lanes_cases.py (the plans' route, the refusals,
the split peak and the ragged form against the JAX buckets): their bodies
and helpers are there, unchanged; this file collects them."""
from torch_prox_lanes_cases import (  # noqa: F401
    test_torch_plans_take_the_lanes_route_from_the_crossover,
    test_torch_lanes_route_refusals,
    test_torch_lanes_split_peak_matches_argmin,
    test_torch_ragged_form_matches_jax_buckets)
