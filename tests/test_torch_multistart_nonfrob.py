"""The port's fit_multistart for the beta divergence on constrained modes
against the JAX package's, on the CPU in float64: a 14 x 10 x 12 rank-2
tensor (tests/test_torch_nonfrob_fit.py's _cp3) under beta 1.5 with
non-negativity on modes 0 and 2, 4 starts over a fixed 4 iterations.  Each
step of the constrained-only inner loop runs the lanes L-BFGS-B
(ops/lbfgsb.py) nested in models/admm.run_inner: a start that the inner
loop has stopped takes no L-BFGS-B iteration and does not move (start 2
stops its loops after one step from the second iteration on, the others
run all five).

From these inits (JAX keys 0-3) the packages' fits agree within 1e-14.
Also each coupling type 1-5 with a KL dataset (tests/
test_torch_nonfrob_coupled.py's problems) and adaptive_rho_nonfrob (each
start's own rho scales carried on the start axis): 2 starts against the
port's own fit a start.
(Under IS on the same problem the fits from keys 2 and 3 take other
L-BFGS-B counts in the JAX fit and the port's own fit: rounding decides
their stop tests, tests/test_torch_nonfrob_fit.py's docstring.)
"""
import warnings

import numpy as np
import pytest

from matlab_code_tpu import AlgOptions, ConstraintSpec, InitOptions
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.multistart import fit_multistart

from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy)
from matlab_code_tpu_torch.models.multistart import _fit_lanes
from matlab_code_tpu_torch.models.solver import fit
from matlab_code_tpu.options import LbfgsbOptions
from test_torch_nonfrob_coupled import _config
from test_torch_nonfrob_fit import _cp3, _opts, problem, to_port

KEYS = (0, 1, 2, 3)
NN = ConstraintSpec("non-negativity")
STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl")


@pytest.fixture(scope="module")
def runs():
    spec, data, _ = problem(_cp3("beta", 1.5, constraints=(NN, None, NN)),
                            ["rand+0.1"] * 3)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1, 1),))
    opts = _opts(4)
    ref = fit_multistart(spec, data, opts, init, n_starts=len(KEYS),
                         keys=KEYS)
    port = (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            [state_from_numpy(init_coupled(spec, data, init, key=k),
                              device="cpu") for k in KEYS],
            options_from_reference(opts))
    return ref, _fit_lanes(*port), port


def test_torch_multistart_beta_constrained_matches_jax(runs):
    """The finals and the best start's streams at rtol 1e-8; the stop
    iterations, the best start's innerIters and lbfgsb_iterations
    equal."""
    (_, rout, rfinals, rstops), lanes, _ = runs
    _, out, finals, stops = lanes.best()
    assert list(stops) == [int(s) for s in rstops]
    np.testing.assert_allclose(finals, rfinals, rtol=1e-8)
    for s in STREAMS:
        np.testing.assert_allclose(getattr(out, s), getattr(rout, s),
                                   rtol=1e-8, atol=1e-14, err_msg=s)
    np.testing.assert_array_equal(out.innerIters, rout.innerIters)
    np.testing.assert_array_equal(out.lbfgsb_iterations,
                                  rout.lbfgsb_iterations)


def test_torch_multistart_beta_stopped_starts_do_not_move(runs):
    """Every start as the port's own fit from its init: the inner loops
    stop at other steps in different starts, and each start's inner and
    L-BFGS-B counts and streams are its own fit's (a start stopped by
    run_inner took no L-BFGS-B iteration in the steps after its stop)."""
    _, lanes, (spec, data, states, opts) = runs
    inner = [o.innerIters[[0, 2], 2:] for o in lanes.outs]
    assert min(i.max() for i in inner) < max(i.max() for i in inner)
    for s, st in enumerate(states):
        _, own = fit(spec, data, st, opts, validate=False)
        got = lanes.outs[s]
        np.testing.assert_array_equal(got.innerIters, own.innerIters)
        np.testing.assert_array_equal(got.lbfgsb_iterations,
                                      own.lbfgsb_iterations)
        for k in STREAMS:
            np.testing.assert_allclose(getattr(got, k), getattr(own, k),
                                       rtol=1e-10, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("case", [1, 2, 3, 4, 5, "adaptive"])
def test_torch_multistart_kl_coupled_and_adaptive_rho(case):
    """Two starts (the JAX init state and it scaled by 1.05) for 3
    iterations, each against the port's own fit: streams within 1e-10,
    inner and L-BFGS-B counts equal."""
    if case == "adaptive":
        spec, data, st0 = problem(_cp3("KL", constraints=(NN, None, NN)),
                                  ["rand+0.1"] * 3)
    else:
        spec, data, st0 = _config(case)
    opts = options_from_reference(AlgOptions(
        MaxOuterIters=3, AbsFuncTol=0.0, OuterRelTol=0.0,
        adaptive_rho_nonfrob=case == "adaptive",
        lbfgsb=LbfgsbOptions(m=5, maxIts=100, pgtol=1e-7)))
    tspec, tdata, tst = to_port(spec, data, st0)
    states = [tst, tst.replace(fac=tuple(f * 1.05 for f in tst.fac))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the data are not counts
        lanes = _fit_lanes(tspec, tdata, states, opts)
        owns = [fit(tspec, tdata, st, opts)[1] for st in states]
    for got, own in zip(lanes.outs, owns):
        np.testing.assert_array_equal(got.innerIters, own.innerIters)
        np.testing.assert_array_equal(got.lbfgsb_iterations,
                                      own.lbfgsb_iterations)
        for k in STREAMS:
            np.testing.assert_allclose(getattr(got, k), getattr(own, k),
                                       rtol=1e-10, atol=1e-14, err_msg=k)
