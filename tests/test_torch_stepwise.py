"""The port's fit_stepwise and checkpoints (utils/checkpoint.py) against
the JAX package: fit_stepwise against the JAX fit_stepwise on dense,
sparse, EM, pairwise-perturbation and PARAFAC2 (a delayed Bk constraint)
problems and against the port's own fit; the checkpoint round trip of
every field (None slots, P, DeltaB and mu_DeltaB included), checkpoints
crossing between the packages both ways bit for bit, and a resumed fit.
Everything runs in float64 on the CPU.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models import solver as jsolver
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.problem import SparseTensor as JSparseTensor
from matlab_code_tpu.utils import checkpoint as jckpt
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    options_from_reference, state_to_numpy)
from matlab_code_tpu_torch.state import FIELDS
from test_torch_em import STREAMS, em_cp, to_port

NN = ConstraintSpec("non-negativity")


def _cp(layout="dense"):
    """tests/test_sparse_stepwise.py's 10x11x12 rank-2 problem, dense or
    as a COO tensor."""
    spec = ProblemSpec(
        mode_sizes=(10, 11, 12),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0, distr=["rand", "randn", "randn"],
        rng=4)
    data, _ = normalize_data(spec, data)
    if layout == "sparse":
        X = np.array(data.objects[0])
        X[np.random.default_rng(9).uniform(size=X.shape) < 0.5] = 0.0
        data = dataclasses.replace(data, objects=(JSparseTensor.from_dense(X),))
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1),))
    return spec, data, init_coupled(spec, data, init, key=3)


def _pp():
    """tests/test_pairwise.py's 20x30x40 problem (noise 0.02)."""
    spec = ProblemSpec(
        mode_sizes=(20, 30, 40),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1, 1]], noise=0.02, distr=["rand", "randn", "randn"],
        rng=7)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1, 1),))
    return spec, data, init_coupled(spec, data, init, key=1)


def _cp_par2():
    """tests/test_aux.py's CP + PARAFAC2 pair coupled by type 0 on the
    first modes (non-negative), with P, DeltaB and mu_DeltaB in its state
    and None slots among its constraint fields."""
    spec = ProblemSpec(
        mode_sizes=(8, 9, 10, 8, (7,) * 4, 4),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=2,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(NN, None, None, NN, None, None))
    distr = ["rand", "randn", "randn", "rand", "rand", "rand+0.1"]
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]] * 2, noise=0.0, distr=distr, rng=3)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=tuple(distr), normalize=True,
                       lambdas_init=((1, 1),) * 2)
    return spec, data, init_coupled(spec, data, init, key=2)


def _par2_delayed():
    """One PARAFAC2 dataset with a unimodal Bk switched on at iteration 4
    (script 9's options, rho_Bk x10)."""
    sizes, I, R = (8,) * 5, 10, 3
    rng = np.random.default_rng(6)
    A = rng.uniform(size=(I, R))
    C = rng.uniform(0.5, 1.5, size=(len(sizes), R))
    from matlab_code_tpu.problem import Parafac2Tensor, ProblemData
    X = Parafac2Tensor.from_list(
        [A @ np.diag(C[k]) @ rng.uniform(size=(J, R)).T
         + 0.05 * rng.uniform(size=(I, J)) for k, J in enumerate(sizes)])
    spec = ProblemSpec(
        mode_sizes=(I, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, ConstraintSpec("unimodality", (True,)), NN))
    data = ProblemData(objects=(X,), coupl_trafo=(None,) * 3,
                       coupl_trafo2=(None,) * 3)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
    return spec, data, init_coupled(spec, data, init, key=3)


def _hold(out, ref, miss=False):
    assert out.OuterIterations == ref.OuterIterations
    for s in STREAMS[:4] + (STREAMS[4:] if miss else ()):
        np.testing.assert_allclose(getattr(out, s), getattr(ref, s),
                                   rtol=1e-8, atol=1e-12, err_msg=s)
    np.testing.assert_array_equal(out.innerIters, ref.innerIters)
    assert out.exit_flag == ref.exit_flag
    assert len(out.time_at_it) == out.OuterIterations + 1
    assert np.all(np.diff(out.time_at_it) >= 0)


CASES = {
    "dense": (_cp, AlgOptions(MaxOuterIters=200, AbsFuncTol=1e-10,
                              OuterRelTol=1e-9)),
    "sparse": (lambda: _cp("sparse"), AlgOptions(
        MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)),
    "em": (em_cp, AlgOptions(MaxOuterIters=2000, AbsFuncTol=1e-10,
                             OuterRelTol=1e-9)),
    "pp": (_pp, AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0,
                           cp_pairwise_perturbation=True)),
    "par2_delayed_bk": (_par2_delayed, AlgOptions(
        MaxOuterIters=10, AbsFuncTol=0.0, OuterRelTol=0.0,
        iter_start_PAR2Bkconstraint=4, increase_factor_rhoBk=10.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_fit_stepwise_matches_jax(case):
    """The port's fit_stepwise against the JAX fit_stepwise from the same
    init: the same iterations and exit, every stream (func_rel_missing of
    the EM case; the PP case's last entry its exact objective) at rtol
    1e-8, innerIters equal, non-decreasing wall times."""
    build, opts = CASES[case]
    spec, data, state0 = build()
    _, ref = jsolver.fit_stepwise(spec, data, state0, opts)
    tspec, tdata, tstate0 = to_port(spec, data, state0)
    _, out = tp.fit_stepwise(tspec, tdata, tstate0,
                             options_from_reference(opts))
    _hold(out, ref, miss=case == "em")
    if case == "em":
        np.testing.assert_allclose(out.f_rel_missing, ref.f_rel_missing,
                                   rtol=1e-8, atol=1e-12)
    else:
        assert np.isnan(out.f_rel_missing) and out.func_rel_missing is None


@pytest.mark.parametrize("case", ["dense", "par2_delayed_bk"])
def test_torch_fit_stepwise_matches_fit(case):
    """The port's fit_stepwise and fit run the same iteration: in float64
    the same streams bit for bit, the same exit and innerIters."""
    build, opts = CASES[case]
    tspec, tdata, tstate0 = to_port(*build())
    opts = options_from_reference(opts)
    s1, o1 = tp.fit(tspec, tdata, tstate0, opts)
    s2, o2 = tp.fit_stepwise(tspec, tdata, tstate0, opts)
    assert o1.OuterIterations == o2.OuterIterations
    assert o1.exit_flag == o2.exit_flag
    for s in STREAMS[:4]:
        np.testing.assert_array_equal(getattr(o1, s), getattr(o2, s))
    np.testing.assert_array_equal(o1.innerIters, o2.innerIters)
    for a, b in zip(s1.fac, s2.fac):
        assert torch.equal(a, b)


def _assert_states_equal(a: dict, b: dict):
    for f in FIELDS:
        assert len(a[f]) == len(b[f]), f
        for x, y in zip(a[f], b[f]):
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)


def _jax_fields(state):
    return {f: tuple(None if x is None else np.asarray(x)
                     for x in getattr(state, f)) for f in FIELDS}


def test_torch_checkpoint_round_trip(tmp_path):
    """save_state / load_state of a CP + PARAFAC2 state after 5 iterations:
    every field bit-equal, None slots kept, P, DeltaB and mu_DeltaB
    included, the JAX package's npz layout (keys and __meta__), on the
    device asked for."""
    spec, data, state0 = _cp_par2()
    tspec, tdata, tstate0 = to_port(spec, data, state0)
    st, _ = tp.fit(tspec, tdata, tstate0,
                   tp.AlgOptions(MaxOuterIters=5, AbsFuncTol=0.0,
                                 OuterRelTol=0.0))
    path = os.path.join(tmp_path, "port.npz")
    tp.save_state(path, st)
    back = tp.load_state(path, device="cpu")
    _assert_states_equal(state_to_numpy(back), state_to_numpy(st))
    assert all(x.device.type == "cpu" for f in FIELDS
               for x in getattr(back, f) if x is not None)
    got = state_to_numpy(back)
    assert got["constraint_fac"][1] is None and got["P"][0] is None
    assert all(got[f][1] is not None for f in ("P", "DeltaB", "mu_DeltaB"))
    with np.load(path) as z:
        assert z["__meta__"].dtype == np.int64
        assert z["__meta__"].tolist() == [len(got[f]) for f in FIELDS]
        assert sorted(z.files) == sorted(
            ["__meta__"] + [f"{f}.{i}" for f in FIELDS
                            for i, x in enumerate(got[f]) if x is not None])


def test_torch_checkpoint_crosses_packages_and_resumes(tmp_path):
    """A state the JAX package saved loads in the port bit for bit and one
    the port saved loads in the JAX package bit for bit; the port's fit
    resumed from the JAX checkpoint matches the JAX fit resumed from it
    (rtol 1e-8, innerIters equal)."""
    spec, data, state0 = _cp_par2()
    opts = AlgOptions(MaxOuterIters=5, AbsFuncTol=0.0, OuterRelTol=0.0)
    jstate, _ = jsolver.fit(spec, data, state0, opts)
    jpath = os.path.join(tmp_path, "jax.npz")
    jckpt.save_state(jpath, jstate)
    tstate = tp.load_state(jpath, device="cpu")
    _assert_states_equal(state_to_numpy(tstate), _jax_fields(jstate))
    tpath = os.path.join(tmp_path, "port.npz")
    tp.save_state(tpath, tstate)
    _assert_states_equal(_jax_fields(jckpt.load_state(tpath)),
                         _jax_fields(jstate))
    _, ref = jsolver.fit(spec, data, jckpt.load_state(jpath), opts)
    tspec, tdata, _ = to_port(spec, data, state0)
    _, out = tp.fit(tspec, tdata, tstate, options_from_reference(opts))
    _hold(out, ref)
    # the port's own checkpoint resumes the same way
    _, again = tp.fit(tspec, tdata, tp.load_state(tpath, device="cpu"),
                      options_from_reference(opts))
    for s in STREAMS[:4]:
        np.testing.assert_array_equal(getattr(again, s), getattr(out, s))
