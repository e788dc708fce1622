"""The port's PARAFAC2 fits against the JAX package: the pinned goldens
par2_nonneg and tpar2, fits over a fixed iteration count (AbsFuncTol =
OuterRelTol = 0) on the same data and init state (ragged slices, a delayed
unimodal Bk, TV on ragged Bk, the par2C branches of coupling types 0-5,
CP+PAR2 coupled on the A mode, inner_solve='newton', par2_polar='ns'),
and the PARAFAC2 errors of check_data_input.

Data and init state come from the JAX package and cross to the port as
numpy arrays (matlab_code_tpu_torch.convert); everything runs in float64 on
the CPU.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.problem import (
    ProblemData, Parafac2Tensor, check_data_input as jcheck)

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models.solver import fit as tfit
from matlab_code_tpu_torch.problem import check_data_input as tcheck
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


def _coupled_case(ctype, rng, K):
    """(mode sizes of the CP tensor's coupled mode and of the PAR2 C mode,
    H of each, H2 of each, delta_shapes) for the CP mode 2 / PAR2 C mode
    coupling of type ctype; R = 3."""
    R = 3
    if ctype == 0:
        return K, (None, None), (None, None), None
    if ctype == 1:   # double sampling rate, as script 14
        H = np.zeros((K // 2, K))
        H[np.arange(K // 2), 2 * np.arange(K // 2)] = 1.0
        return K // 2, (np.eye(K // 2), H), (None, None), None
    if ctype == 2:
        return K, tuple(rng.standard_normal((R, 2)) + 2 * np.eye(R, 2)
                        for _ in range(2)), (None, None), None
    if ctype == 3:
        return K, tuple(rng.standard_normal((K, 4)) for _ in range(2)), \
            (None, None), None
    if ctype == 4:
        return K, tuple(rng.standard_normal((2, R)) for _ in range(2)), \
            (None, None), None
    # the par2C rows solve Delta's rows (cmtf_fun_AOADMM.m:1026-1054), so
    # Delta has K rows: H maps onto K rows for both modes
    return K, (np.eye(K), rng.standard_normal((K, K)) + 3 * np.eye(K)), \
        (np.eye(R), np.eye(R)), {1: (K, R)}


@pytest.mark.parametrize("ctype", [0, 1, 2, 3, 4, 5])
def test_torch_par2C_coupled_fit_matches_jax(ctype):
    """A CP tensor's third mode coupled to a PARAFAC2 C mode by each
    coupling type (the par2C branches: per-row rho, the kron-vectorized
    system of types 1 and 5, the row-wise Delta systems of types 4 and 5),
    and type 0 also on the A mode (scripts 1 and 14), 8 outer iterations
    against the JAX fit."""
    K = 6
    rng = np.random.default_rng(20 + ctype)
    kc, H, H2, dshapes = _coupled_case(ctype, rng, K)
    lin = (2, 0, 1, 2, 0, 1) if ctype == 0 else (0, 0, 1, 0, 0, 1)
    types = (ctype, 0) if ctype == 0 else (ctype,)
    spec = ProblemSpec(
        mode_sizes=(7, 5, kc, 7, (6,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=lin, coupling_type=types),
        constraints=(NN, None, NN, NN, None, NN))
    objs = _par2_data((6,) * K, 7, 3, seed=ctype, cp_shape=(7, 5, kc))
    trafo = (None, None, H[0], None, None, H[1])
    trafo2 = (None, None, H2[0], None, None, H2[1]) if ctype == 5 else ()
    _, out = _fit_both(spec, objs, _opts(), trafo=trafo, trafo2=trafo2,
                       delta_shapes=dshapes)
    assert out.OuterIterations == ITERS


def test_torch_check_data_input_par2_errors():
    """The PARAFAC2 rules of check_data_input raise in the port where they
    raise in the JAX package: rank above a slice size, tPARAFAC2 off the Bk
    mode or on ragged slices, GL smoothness on ragged slices, a coupled Bk
    mode, a C mode whose size is not K."""
    def spec(sizes=(5, 5, 5), cons=(None, None, None), lin=(0, 0, 0),
             types=(), R=3, c=3):
        return ProblemSpec(
            mode_sizes=(4, sizes, c),
            datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
            coupling=CouplingSpec(lin, types), constraints=cons)

    T = ConstraintSpec("tPARAFAC2", (1.0,))
    bad = [spec(R=6), spec(cons=(T, None, None)),
           spec(sizes=(5, 4, 5), cons=(None, T, None)),
           spec(sizes=(5, 4, 5), cons=(None, ConstraintSpec(
               "GL smoothness", (1.0,)), None)),
           spec(lin=(0, 1, 0), types=(0,)), spec(c=4)]
    for s in bad:
        with pytest.raises(ValueError) as jerr:
            jcheck(s)
        with pytest.raises(ValueError) as terr:
            tcheck(spec_from_reference(s))
        assert str(terr.value)[:40] == str(jerr.value)[:40]
    jcheck(spec())
    tcheck(spec_from_reference(spec()))


def test_torch_par2_cmtf_aoadmm_from_its_own_init():
    """The port's entry point on a PARAFAC2 problem on the CPU, from its own
    init (torch.Generator draws; P_k = I on each slice's J_k rows, the
    padding zero), with a Zhat of {A, Bk (true sizes), C}; nvecs init too."""
    sizes = (7, 9, 8, 9)
    spec = tp.ProblemSpec(
        mode_sizes=(6, sizes, 4),
        datasets=(tp.DatasetSpec("PAR2", (0, 1, 2), 2),),
        constraints=(tp.ConstraintSpec("non-negativity"), None,
                     tp.ConstraintSpec("non-negativity")))
    objs = _par2_data(sizes, 6, 2, seed=9)
    data = data_from_numpy(objs, device="cpu")
    for nvecs in (False, True):
        init = tp.InitOptions(distr=("rand",) * 3, nvecs=nvecs)
        state0 = tp.init_coupled(spec, data, init, seed=1)
        assert state0.fac[1].shape == state0.P[0].shape == (4, 9, 2)
        assert state0.DeltaB[0].shape == (2, 2)
        for k, J in enumerate(sizes):
            assert torch.equal(state0.P[0][k, :J],
                               torch.eye(J, 2, dtype=torch.float64))
            assert not bool(state0.fac[1][k, J:].any())
            assert not bool(state0.mu_DeltaB[0][k, J:].any())
        zhat, _, _, out = tp.cmtf_aoadmm(
            spec, data, tp.AlgOptions(MaxOuterIters=30), init=state0)
        assert out.func_val_conv[-1] < 0.2 * out.func_val_conv[0]
        assert [b.shape for b in zhat[0]["Bk"]] == [(J, 2) for J in sizes]
        assert zhat[0]["A"].shape == (6, 2) and zhat[0]["C"].shape == (4, 2)
