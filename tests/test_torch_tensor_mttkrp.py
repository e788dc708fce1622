"""Tests of tests/torch_tensor_cases.py (the MTTKRP against the JAX package and
the Pallas kernel, the plain version's type and devices): their bodies and
helpers are there, unchanged; this file collects them."""
from torch_tensor_cases import (  # noqa: F401
    test_torch_mttkrp_matches_jax,
    test_torch_mttkrp_mode0_matches_pallas_interpret,
    test_torch_mttkrp3_reference_promotes_to_float32,
    test_torch_mttkrp3_rejects_other_devices)
