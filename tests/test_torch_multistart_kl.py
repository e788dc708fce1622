"""The port's fit_multistart for the KL loss against the JAX package's, on
the CPU in float64: example script 07's configuration
(examples/script07_matrix_cp_kl.py:15-30: KL on a 50 x 30 x 40 tensor and
a 50 x 70 matrix, coupled by type 0, its options), 2 starts over a fixed
3 iterations (AbsFuncTol = OuterRelTol = 0).  Every factor step is the
lanes form of L-BFGS-B (ops/lbfgsb.py) inside the coupled inner loop: the
finals and the best start's streams at rtol 1e-8, the stop iterations,
innerIters and lbfgsb_iterations equal, and each start as the port's own
fit from its init.

The factors are drawn from 'rand+0.1' and the starts from the JAX keys 4
and 5: from most inits this fit is decided by rounding (from keys 3 and 6
the JAX fit and the port's fit take other L-BFGS-B counts; from
fold_in(PRNGKey(0), 1) the JAX fit and the JAX fit_multistart differ by
2.3e-8 after one iteration; tests/test_torch_nonfrob_fit.py's docstring),
from these two the packages' fits agree within 1e-11.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from matlab_code_tpu import InitOptions
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.multistart import fit_multistart

from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy)
from matlab_code_tpu_torch.models import admm
from matlab_code_tpu_torch.models.multistart import _fit_lanes
from matlab_code_tpu_torch.models.solver import fit
from test_torch_nonfrob_fit import problem

KEYS = (4, 5)
STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl")


@pytest.fixture(scope="module")
def runs():
    """(the JAX fit_multistart's result, the port's lanes, the port's
    problem, states and options), computed once: the JAX vmapped L-BFGS-B
    compiles slowly."""
    import examples.script07_matrix_cp_kl as s07
    cfg = s07.build(small=True)
    spec, data, _ = problem(cfg["spec"], ["rand+0.1"] * 5, cfg["init_distr"],
                            key=cfg["key"])
    init = InitOptions(distr=("rand",) * 5, normalize=True,
                       lambdas_init=((1, 1, 1), (1, 1, 1)))
    opts = dataclasses.replace(cfg["opts"], MaxOuterIters=3, AbsFuncTol=0.0,
                               OuterRelTol=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the data are not counts
        ref = fit_multistart(spec, data, opts, init, n_starts=len(KEYS),
                             keys=KEYS)
    port = (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            [state_from_numpy(init_coupled(spec, data, init, key=k),
                              device="cpu") for k in KEYS],
            options_from_reference(opts))
    admm.to_host.calls = 0
    lanes = _fit_lanes(*port)
    return ref, lanes, port, admm.to_host.calls


def test_torch_multistart_kl_finals_and_streams(runs):
    """The finals and the best start's four streams at rtol 1e-8, the
    same best start and stop iterations."""
    (_, rout, rfinals, rstops), lanes, _, _ = runs
    _, out, finals, stops = lanes.best()
    assert list(stops) == [int(s) for s in rstops]
    assert int(np.argmin(finals)) == int(np.argmin(rfinals))
    np.testing.assert_allclose(finals, rfinals, rtol=1e-8)
    for s in STREAMS:
        np.testing.assert_allclose(getattr(out, s), getattr(rout, s),
                                   rtol=1e-8, atol=1e-14, err_msg=s)
    assert out.exit_flag == rout.exit_flag


def test_torch_multistart_kl_counts(runs):
    """The best start's innerIters and lbfgsb_iterations (a row a mode,
    the L-BFGS-B iterations of each outer iteration) equal the JAX
    function's."""
    (_, rout, _, _), lanes, _, _ = runs
    out = lanes.best()[1]
    np.testing.assert_array_equal(out.innerIters, rout.innerIters)
    np.testing.assert_array_equal(out.lbfgsb_iterations,
                                  rout.lbfgsb_iterations)
    assert out.lbfgsb_iterations.shape == (5, 4)
    assert out.lbfgsb_iterations[:, 1:].min() > 0


def test_torch_multistart_kl_every_start_is_its_fit(runs):
    """Each start as the port's own fit from its init state: streams
    within 1e-10, inner and L-BFGS-B counts equal; and the reads stay
    below the sum of the starts' own fits' reads (one read a line-search
    try serves both starts)."""
    _, lanes, (spec, data, states, opts), reads = runs
    own_reads = 0
    for s, st in enumerate(states):
        admm.to_host.calls = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, own = fit(spec, data, st, opts, validate=False)
        own_reads += admm.to_host.calls
        got = lanes.outs[s]
        np.testing.assert_array_equal(got.innerIters, own.innerIters)
        np.testing.assert_array_equal(got.lbfgsb_iterations,
                                      own.lbfgsb_iterations)
        for k in STREAMS:
            np.testing.assert_allclose(getattr(got, k), getattr(own, k),
                                       rtol=1e-10, atol=1e-14, err_msg=k)
    assert reads < own_reads
