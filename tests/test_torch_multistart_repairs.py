"""Three repairs of fit_multistart and the fits, on the CPU in float64:
  * cp_pairwise_perturbation on the start axis: the JAX fit_multistart
    builds its step without the pairwise datasets and runs the exact
    MTTKRPs (matlab_code_tpu/models/multistart.py:133), so the port's lanes
    take the same exact trajectory, with the option on and off;
  * a string base_key seeds start s with the int of its sha256's first 8
    hex digits plus s (the JAX function's hash,
    matlab_code_tpu/models/multistart.py:80-83);
  * fit, fit_stepwise and fit_multistart scope the matmul precision to the
    call: both of torch's TF32 switches are as the caller left them after
    the call, as the JAX package's with_matmul_precision scopes jax's.
"""
import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch

from matlab_code_tpu import AlgOptions
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.multistart import fit_multistart

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy)
from matlab_code_tpu_torch.models.multistart import _fit_lanes
from matlab_code_tpu_torch.utils import multistart_workload as mw
from test_aux import _small_problem


@pytest.fixture(scope="module")
def pp_runs():
    """tests/test_aux.py's noiseless non-negative 8 x 9 x 10 rank-2 CP
    problem, 2 starts (keys fold_in(PRNGKey(0), s)) for 40 iterations with
    pp_start_tol = pp_refresh_tol = 0.5: the JAX fit_multistart's finals,
    and the port's lanes from the same init states, with the pairwise
    option off and on."""
    spec, data, init = _small_problem(with_par2=False)
    opts = AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0,
                      pp_start_tol=0.5, pp_refresh_tol=0.5)
    root = jax.random.PRNGKey(0)
    states = [state_from_numpy(init_coupled(
        spec, data, init, key=jax.random.fold_in(root, s)), device="cpu")
        for s in range(2)]
    tdata = data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu")
    runs = {}
    for pp in (False, True):
        o = dataclasses.replace(opts, cp_pairwise_perturbation=pp)
        runs[pp] = (fit_multistart(spec, data, o, init, n_starts=2,
                                   base_key=0)[2],
                    _fit_lanes(spec_from_reference(spec), tdata, states,
                               options_from_reference(o)).best()[2])
    return runs


def test_torch_multistart_pp_runs_the_exact_mttkrps(pp_runs):
    """With the pairwise option on, the lanes give the JAX function's
    finals, which are its finals with the option off, and the lanes' own
    finals with it off, bit for bit; before the repair the option
    raised."""
    for pp in (False, True):
        jax_finals, got = pp_runs[pp]
        np.testing.assert_allclose(got, jax_finals, rtol=1e-8, atol=1e-14)
    np.testing.assert_array_equal(pp_runs[True][0], pp_runs[False][0])
    np.testing.assert_array_equal(pp_runs[True][1], pp_runs[False][1])


def test_torch_multistart_string_base_key():
    """base_key="run-a" gives the fit of keys=[h, h + 1], h the int of
    sha256("run-a")'s first 8 hex digits; before the repair it raised."""
    spec, data, opts, init = mw.script15_problem("cpu", torch.float64)
    opts = dataclasses.replace(opts, MaxOuterIters=2)
    h = int(hashlib.sha256(b"run-a").hexdigest()[:8], 16)
    _, _, a, _ = tp.fit_multistart(spec, data, opts, init, 2, base_key="run-a")
    _, _, b, _ = tp.fit_multistart(spec, data, opts, init, 2,
                                   keys=[h, h + 1])
    np.testing.assert_array_equal(a, b)


def _fits():
    """Each entry point on script 15's widths for one iteration."""
    spec, data, opts, init = mw.script15_problem("cpu", torch.float64)
    opts = dataclasses.replace(opts, MaxOuterIters=1)
    state = tp.init_coupled(spec, data, init, seed=0)
    return {
        "fit": lambda o: tp.fit(spec, data, state, o),
        "fit_stepwise": lambda o: tp.fit_stepwise(spec, data, state, o),
        "fit_multistart": lambda o: tp.fit_multistart(spec, data, o, init, 2),
    }, opts


@pytest.mark.parametrize("precision", ["default", "tensorfloat32"])
def test_torch_fits_restore_the_tf32_switches(precision):
    """With both TF32 switches set on, and with both off, before a default
    and a 'tensorfloat32' fit of each entry point, both switches are as
    the caller left them afterwards; before the repair a fit left them at
    its own precision."""
    fits, opts = _fits()
    opts = dataclasses.replace(opts, matmul_precision=precision)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for name, run in fits.items():
            for before in (True, False):
                torch.backends.cuda.matmul.allow_tf32 = before
                torch.backends.cudnn.allow_tf32 = before
                run(opts)
                assert torch.backends.cuda.matmul.allow_tf32 is before, name
                assert torch.backends.cudnn.allow_tf32 is before, name
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
