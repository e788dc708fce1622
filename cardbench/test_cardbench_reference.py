"""The plain reference against the port's CPU path at the test size of
each configuration: the same inputs, the same starting point (the port's
init_coupled from a key, drawn again by the reference's init_state), the
same iterations, in float64."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from cardbench import tiny
from cardbench.check import load_reference
from cardbench.harness import HERE, load_json

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(tiny.CFG))
def test_reference_follows_the_port(name):
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import fit
    cfg = {**load_json(HERE / "configs" / f"{name}.json"), **tiny.CFG[name],
           "dtype": "float64"}
    gen = importlib.import_module(f"cardbench.generators.{cfg['generator']}")
    reference = load_reference(cfg)
    raw = gen.make_raw(cfg, 2**33 + 1, "cpu")
    spec, data, options, init = gen.to_program(raw, cfg)
    options = dataclasses.replace(options, MaxOuterIters=8, AbsFuncTol=0.0,
                                  OuterRelTol=0.0)
    key = 2**40 + 7
    state, out = fit(spec, data, init_coupled(spec, data, init, seed=key),
                     options)
    ref = reference.Reference(raw, dataclasses.asdict(options))
    hist, n_stop, fac = ref.fit(
        reference.init_state(raw, key, torch.float64, "cpu"),
        options.MaxOuterIters)
    hist = np.asarray(hist)
    assert n_stop == out.OuterIterations == 8
    np.testing.assert_allclose(out.func_val_conv, hist[:, 0], rtol=1e-9)
    np.testing.assert_allclose(out.func_coupl_conv, hist[:, 1], rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(out.func_constr_conv, hist[:, 2], rtol=1e-7,
                               atol=1e-12)
    for m, F in fac.items():
        np.testing.assert_allclose(state.fac[m].numpy(), F.numpy(),
                                   rtol=1e-7, atol=1e-10)
