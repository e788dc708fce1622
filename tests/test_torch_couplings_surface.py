"""Coupling types 1, 2, 3 and 5 in the port against the JAX package
(continued from test_torch_couplings.py): the CP surface workload
(matlab_code_tpu_torch/utils/surface.py, shrunk) run through both fits
from one init state, on the CPU in float64.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matlab_code_tpu import (
    AlgOptions, ConstraintSpec, CouplingSpec, DatasetSpec, InitOptions,
    ProblemData, ProblemSpec)
from matlab_code_tpu.models.init import init_coupled as jinit_coupled
from matlab_code_tpu.models.solver import fit as jfit

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    options_from_reference, state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models.solver import fit as tfit
from matlab_code_tpu_torch.utils import surface
from test_torch_couplings import SCALE


def _jax_side(tspec, tdata):
    """The JAX package's spec and data of a port problem (numpy between)."""
    arr = lambda t: None if t is None else jnp.asarray(t.numpy())
    spec = ProblemSpec(
        mode_sizes=tspec.mode_sizes,
        datasets=tuple(DatasetSpec(model=d.model, modes=d.modes, rank=d.rank,
                                   weight=d.weight) for d in tspec.datasets),
        coupling=CouplingSpec(tspec.coupling.lin_coupled_modes,
                              tspec.coupling.coupling_type),
        constraints=tuple(ConstraintSpec(c.kind, c.params)
                          for c in tspec.constraints))
    data = ProblemData(objects=tuple(map(arr, tdata.objects)),
                       coupl_trafo=tuple(map(arr, tdata.coupl_trafo)),
                       coupl_trafo2=tuple(map(arr, tdata.coupl_trafo2)))
    return spec, data


@pytest.mark.parametrize("ctype", surface.CTYPES)
def test_torch_surface_workload_matches_jax(ctype):
    """utils/surface.py's problem (mode sizes / 8, float64 on the CPU):
    the port and the JAX fit from one init state, 3 outer iterations, the
    four objective streams and the factors at rtol 1e-8.  The path runs the
    coupled inner loop of the type, the plain unimodal and TV walks, GL
    smoothness, the column simplex and the l1 prox."""
    tspec, tdata, ds = surface.build_problem(ctype, "cpu", torch.float64,
                                             scale=SCALE)
    assert tspec.mode_sizes == surface.mode_sizes(ctype, SCALE)
    tp.check_data_input(tspec, tdata)
    spec, data = _jax_side(tspec, tdata)
    init = InitOptions(distr=("rand",) * 8, normalize=True)
    state0 = jinit_coupled(spec, data, init, key=3, delta_shapes=ds)
    opts = AlgOptions(MaxOuterIters=3, MaxInnerIters=5, AbsFuncTol=0.0,
                      OuterRelTol=0.0)
    st_ref, out_ref = jfit(spec, data, state0, opts)
    st, out = tfit(tspec, tdata, state_from_numpy(state0, device="cpu"),
                   options_from_reference(opts))
    for a, b in [(out.func_val_conv, out_ref.func_val_conv),
                 (out.func_coupl_conv, out_ref.func_coupl_conv),
                 (out.func_constr_conv, out_ref.func_constr_conv),
                 (out.func_PAR2_coupl, out_ref.func_PAR2_coupl)]:
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-14)
    np.testing.assert_array_equal(out.innerIters, out_ref.innerIters)
    got = state_to_numpy(st)
    for m in range(spec.nb_modes):
        np.testing.assert_allclose(got["fac"][m], np.asarray(st_ref.fac[m]),
                                   rtol=1e-8, atol=1e-10)
