"""The port's PARAFAC2 fits against the JAX package: the pinned goldens
par2_nonneg and tpar2, fits over a fixed iteration count (AbsFuncTol =
OuterRelTol = 0) on the same data and init state (ragged slices, a delayed
unimodal Bk, TV on ragged Bk, inner_solve='newton', par2_polar='ns').
The par2C couplings, check_data_input's PARAFAC2 errors and the entry
point from its own init are in test_torch_parafac2_coupled.py.

Data and init state come from the JAX package and cross to the port as
numpy arrays (matlab_code_tpu_torch.convert); everything runs in float64 on
the CPU.
"""
import os

import numpy as np
import pytest

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.problem import ProblemData, Parafac2Tensor

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models.solver import fit as tfit
from test_torch_solver import GOLDEN_DIR, _golden_problem

NN = ConstraintSpec("non-negativity")
ITERS = 8


def _to_port(spec, data, state):
    return (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            state_from_numpy(state, device="cpu"))


def _streams(out):
    return np.stack([out.func_val_conv, out.func_coupl_conv,
                     out.func_constr_conv, out.func_PAR2_coupl])


@pytest.mark.parametrize("name", ["par2_nonneg", "tpar2"])
def test_torch_par2_fit_reproduces_golden(name, monkeypatch):
    spec, data, state0 = _to_port(*_golden_problem(name, monkeypatch))
    opts = tp.AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out = tfit(spec, data, state0, opts)
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["traj"]
    # the goldens' own tolerance (tests/test_golden_trajectories.py)
    np.testing.assert_allclose(_streams(out), want, rtol=1e-8, atol=1e-12)


def _par2_data(sizes, I, R, seed, cp_shape=None):
    """A PARAFAC2 dataset of slices (I, J_k) with a low-rank part and
    noise, non-negative, and optionally a CP tensor of cp_shape; numpy from
    a seed."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(size=(I, R))
    C = rng.uniform(0.5, 1.5, size=(len(sizes), R))
    slices = [A @ np.diag(C[k]) @ rng.uniform(size=(J, R)).T
              + 0.05 * rng.uniform(size=(I, J)) for k, J in enumerate(sizes)]
    objs = [Parafac2Tensor.from_list(slices)]
    if cp_shape is not None:
        U = [rng.uniform(size=(n, R)) for n in cp_shape]
        objs.insert(0, np.einsum("ir,jr,kr->ijk", *U)
                    + 0.05 * rng.uniform(size=cp_shape))
    return objs


def _fit_both(spec, objs, opts, trafo=(), trafo2=(), delta_shapes=None,
              distr=None, key=3):
    nb = spec.nb_modes
    data = ProblemData(objects=tuple(objs),
                       coupl_trafo=tuple(trafo) or (None,) * nb,
                       coupl_trafo2=tuple(trafo2) or (None,) * nb)
    init = InitOptions(distr=distr or ("rand",) * nb, normalize=True,
                       lambdas_init=tuple((1,) * ds.rank for ds in spec.datasets))
    state0 = init_coupled(spec, data, init, key=key, delta_shapes=delta_shapes)
    st_ref, out_ref = fit(spec, data, state0, opts)
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    st, out = tfit(tspec, tdata, tstate0, options_from_reference(opts))
    np.testing.assert_allclose(_streams(out), _streams(out_ref), rtol=1e-8,
                               atol=1e-14)
    np.testing.assert_array_equal(out.innerIters, out_ref.innerIters)
    got = state_to_numpy(st)
    for m in range(nb):
        np.testing.assert_allclose(got["fac"][m], np.asarray(st_ref.fac[m]),
                                   rtol=1e-6, atol=1e-9)
    return st, out


def _opts(**kw):
    return AlgOptions(MaxOuterIters=ITERS, AbsFuncTol=0.0, OuterRelTol=0.0,
                      **kw)


@pytest.mark.parametrize("case", ["ragged", "unimodal_delayed", "tv_ragged",
                                  "newton", "polar_ns", "tparafac2_ridge"])
def test_torch_par2_fit_matches_jax(case):
    """One PARAFAC2 dataset, 8 outer iterations from the same init state:
    ragged slices (unconstrained Bk), a unimodal Bk switched on at
    iteration 4 with rho_Bk x10 (script 9's options), TV on ragged Bk,
    inner_solve='newton' and par2_polar='ns' (the JAX package's TPU
    paths, which run on any backend), and script 11's tPARAFAC2 (eta 1000)
    with its ridge of 100 on A and C."""
    ragged = (9, 7, 9, 6, 8)
    regular = (8,) * 5
    ridge = None
    if case == "ragged":
        sizes, bk, opts = ragged, None, _opts()
    elif case == "unimodal_delayed":
        sizes, bk = regular, ConstraintSpec("unimodality", (True,))
        opts = _opts(iter_start_PAR2Bkconstraint=4, increase_factor_rhoBk=10.0)
    elif case == "tv_ragged":
        sizes, bk, opts = ragged, ConstraintSpec("TV regularization", (0.05,)), \
            _opts()
    elif case == "newton":
        sizes, bk, opts = ragged, NN, _opts(inner_solve="newton")
    elif case == "polar_ns":
        sizes, bk, opts = regular, None, _opts(par2_polar="ns",
                                               par2_polar_iters=40)
    else:
        sizes, bk, opts = regular, ConstraintSpec("tPARAFAC2", (1000.0,)), \
            _opts()
        ridge = (100.0, 0.0, 100.0)
    spec = ProblemSpec(
        mode_sizes=(10, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, bk, NN), ridge=ridge)
    st, out = _fit_both(spec, _par2_data(sizes, 10, 3, seed=len(case)), opts)
    assert out.OuterIterations == ITERS
    for k, J in enumerate(sizes):
        assert not bool(st.fac[1][k, J:].any())
