"""The port's fit with non-Frobenius losses (KL, IS, beta: the L-BFGS-B
factor steps of models/lbfgs_bridge.py) against the JAX package's fit, in
float64 on the CPU: the pinned golden `cp_kl`, and fits over a fixed
iteration count (AbsFuncTol = OuterRelTol = 0) with the four streams at
rtol 1e-8 and the inner and L-BFGS-B iteration counts equal: IS and beta
(tests/test_beta_is_losses.py's problems), script 07 (KL on a tensor and a
matrix coupled by type 0), KL under non-negativity (the constrained-only
ADMM loop), adaptive_rho_nonfrob and ridge with BSUM.  The coupling types
1-5 are in tests/test_torch_nonfrob_coupled.py.  Also the data-vs-loss
warnings.

Where a factor's data are drawn from Gamma(1, 1) or Gamma(2, 3) (script
07's own draws; this file's KL problem under non-negativity with rng 7),
the JAX fit does not reproduce itself: a 1e-14 relative perturbation of
its init moves its f_tensors by 6.6e-10 after one iteration of script 07
and 3.7e-5 after two (with L-BFGS-B counts that differ), and by 4.0e-8
after six of the non-negative problem.  Every L-BFGS-B run ends on a
threshold test (the relative change of f below 1e-6, the Armijo test, a
bound within 1e-10), and there rounding alone decides.  Those problems
therefore take factors drawn from U(0.1, 1.1) ('rand+0.1'), bounded away
from the bound at 0, where the JAX fit moves by 1e-12 or less under the
same perturbation."""
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    AlgOptions, ConstraintSpec, CouplingSpec, DatasetSpec, InitOptions,
    ProblemSpec)
from matlab_code_tpu.models import solver as jsolver
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.options import LbfgsbOptions
from matlab_code_tpu.utils.datagen import create_coupled_data

from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models import solver as tsolver

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def to_port(spec, data, state):
    return (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            state_from_numpy(state, device="cpu"))


def problem(spec, distr, init_distr=None, key=2, rng=7, trafo=None,
            trafo2=None, delta_shapes=None):
    """Noise-free data of spec's ranks (unit lambdas) and an init state,
    from the JAX package's generators."""
    lambdas = [[1] * ds.rank for ds in spec.datasets]
    data, _, _, _ = create_coupled_data(
        spec, lambdas=lambdas, noise=0.0, distr=distr, rng=rng,
        coupl_trafo=trafo, coupl_trafo2=trafo2)
    init = InitOptions(distr=tuple(init_distr or ["rand"] * len(distr)),
                       normalize=True,
                       lambdas_init=tuple(tuple(l) for l in lambdas))
    return spec, data, init_coupled(spec, data, init, key=key,
                                    delta_shapes=delta_shapes)


def compare_fits(spec, data, state0, opts):
    """The JAX fit and the port's fit from one init state: streams at rtol
    1e-8 (atol 1e-12 for streams at rounding-level zero), the inner and
    L-BFGS-B iteration counts equal, each factor within 1e-8 of its norm."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the data-vs-loss warnings
        jst, jout = jsolver.fit(spec, data, state0, opts)
        tst, tout = tsolver.fit(*to_port(spec, data, state0),
                                options_from_reference(opts))
    assert tout.OuterIterations == jout.OuterIterations == opts.MaxOuterIters
    for name in ("func_val_conv", "func_coupl_conv", "func_constr_conv",
                 "func_PAR2_coupl"):
        np.testing.assert_allclose(getattr(tout, name), getattr(jout, name),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(tout.innerIters, jout.innerIters)
    np.testing.assert_array_equal(tout.lbfgsb_iterations,
                                  jout.lbfgsb_iterations)
    assert tout.lbfgsb_iterations.sum() > 0
    for a, b in zip(state_to_numpy(tst)["fac"], jst.fac):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-8 * np.linalg.norm(b)
    return tout


class _AtFit(Exception):
    """Raised in place of the JAX fit, carrying its spec, data and state."""


def test_torch_fit_reproduces_golden_cp_kl(monkeypatch):
    """tests/golden/cp_kl.npz, its configuration taken from
    tests/test_golden_trajectories.py's _run_config where it would call
    the JAX fit."""
    import test_golden_trajectories as gt

    def at_fit(spec, data, state0, opts):
        raise _AtFit(spec, data, state0, opts)

    monkeypatch.setattr(gt, "fit", at_fit)
    with pytest.raises(_AtFit) as caught:
        gt._run_config("cp_kl")
    spec, data, state0, opts = caught.value.args
    _, out = tsolver.fit(*to_port(spec, data, state0),
                         options_from_reference(opts))
    traj = np.stack([out.func_val_conv, out.func_coupl_conv,
                     out.func_constr_conv, out.func_PAR2_coupl])
    want = np.load(os.path.join(GOLDEN_DIR, "cp_kl.npz"))["traj"]
    np.testing.assert_allclose(traj, want, rtol=1e-8, atol=1e-12)
    assert out.lbfgsb_iterations.shape == (3, 41)


def _cp3(loss, param=None, constraints=(None,) * 3, **kw):
    return ProblemSpec(
        mode_sizes=(14, 10, 12),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2, loss=loss,
                              loss_param=param),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=constraints, **kw)


def _opts(n, **kw):
    return AlgOptions(MaxOuterIters=n, AbsFuncTol=0.0, OuterRelTol=0.0,
                      lbfgsb=LbfgsbOptions(m=5, maxIts=100, pgtol=1e-7), **kw)


@pytest.mark.parametrize("loss,param", [("IS", None), ("beta", 1.5)])
def test_torch_fit_matches_jax_is_and_beta(loss, param):
    """tests/test_beta_is_losses.py's problems (Gamma-distributed factors,
    rand init, key 2) over 8 iterations."""
    spec, data, state0 = problem(_cp3(loss, param), [("gamma", 3.0, 2.0)] * 3)
    compare_fits(spec, data, state0, _opts(8))


def test_torch_fit_matches_jax_script07():
    """examples/script07_matrix_cp_kl.py: a 50 x 30 x 40 tensor and a 50 x
    70 matrix of KL loss coupled by type 0, its options, its init and key,
    2 iterations; the factors drawn from 'rand+0.1' (module docstring).
    After one iteration f_tensors differs by 2e-11 between the packages
    (the fit amplifies rounding ~1e4-fold an iteration here), and after
    three f_couplings, a residual of 2e-3, by 8e-8."""
    import examples.script07_matrix_cp_kl as s07
    cfg = s07.build(small=True)
    spec, data, state0 = problem(cfg["spec"], ["rand+0.1"] * 5,
                                 cfg["init_distr"], key=cfg["key"])
    opts = dataclasses.replace(cfg["opts"], MaxOuterIters=2, AbsFuncTol=0.0,
                               OuterRelTol=0.0)
    out = compare_fits(spec, data, state0, opts)
    assert out.innerIters[:, 1:].min() >= 1


NN = ConstraintSpec("non-negativity")


@pytest.mark.parametrize("adaptive", [False, True])
def test_torch_fit_matches_jax_kl_nonneg(adaptive):
    """Non-negativity on modes 0 and 2: the L-BFGS-B step inside the
    constrained-only ADMM loop; with adaptive_rho_nonfrob, the residual
    balancing of rho."""
    spec, data, state0 = problem(_cp3("KL", constraints=(NN, None, NN)),
                                 ["rand+0.1"] * 3)
    out = compare_fits(spec, data, state0,
                       _opts(6, adaptive_rho_nonfrob=adaptive))
    assert out.innerIters[[0, 2], 1:].max() > 1


def test_torch_fit_matches_jax_kl_ridge_bsum():
    """Ridge on two modes (the reference's halved ridge gradient) and BSUM's
    proximal term in every L-BFGS-B evaluation."""
    spec, data, state0 = problem(_cp3("KL", ridge=(0.1, 0.0, 0.05)),
                                 [("gamma", 2.0, 3.0)] * 3)
    compare_fits(spec, data, state0, _opts(5, bsum=True, bsum_weight=0.5))


def test_torch_warn_loss_data_matches_jax():
    """KL on data that are not counts and IS on data that are not positive
    warn, as the JAX package's _warn_loss_data does; count data do not."""
    spec = ProblemSpec(
        mode_sizes=(4, 3, 4, 5, 4, 2),
        datasets=(DatasetSpec("CP", (0, 1), 2, loss="KL"),
                  DatasetSpec("CP", (2, 3), 2, loss="IS"),
                  DatasetSpec("CP", (4, 5), 2, loss="KL")),
        coupling=CouplingSpec((0,) * 6, ()))
    rng = np.random.default_rng(0)
    objects = (rng.uniform(size=(4, 3)),                 # KL, not counts
               rng.uniform(-1.0, 1.0, size=(4, 5)),      # IS, not positive
               rng.poisson(3.0, size=(4, 2)).astype(float))  # counts
    from matlab_code_tpu.problem import ProblemData
    jdata = ProblemData(objects=objects, coupl_trafo=(None,) * 6,
                        coupl_trafo2=(None,) * 6)
    tdata = data_from_numpy(objects, (None,) * 6, (None,) * 6, device="cpu")
    got, want = [], []
    for fn, sp, d, sink in ((tsolver._warn_loss_data, spec_from_reference(spec),
                             tdata, got),
                            (jsolver._warn_loss_data, spec, jdata, want)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(sp, d)
        sink.extend(str(w.message) for w in caught)
    assert got == want == ["Using 'KL' but dataset 0 is not count data",
                           "Using 'IS' but dataset 1 is not positive"]
