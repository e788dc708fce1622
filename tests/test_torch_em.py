"""The port's EM imputation of missing data against the JAX package:
em_impute, the masked branches of func_eval and the masked PARAFAC2 data
constant on CP, regular and ragged PARAFAC2 datasets; the golden
cp_em_missing; and example script 12's MATLAB-seeded replay (CP and PARAFAC2 with 20 % of their entries missing, coupled by type
0) with the port doing the fit.  The EM fits of
tests/test_losses_missing.py through both packages are in
test_torch_em_fit.py.

Data, masks and init states come from the JAX package and cross to the
port as numpy arrays (matlab_code_tpu_torch.convert); everything runs in
float64 on the CPU.
"""
import dataclasses
import importlib
import os

import numpy as np
import pytest
import jax.numpy as jnp

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models import objective as jobjective
from matlab_code_tpu.models import solver as jsolver
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.problem import Parafac2Tensor
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy)
from matlab_code_tpu_torch.models import objective as tobjective
from matlab_code_tpu_torch.models import solver as tsolver
from test_torch_solver import GOLDEN_DIR, _golden_problem

NN = ConstraintSpec("non-negativity")
STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl", "func_rel_missing")


def to_port(spec, data, state):
    """A JAX-package problem on the port's CPU, its missing masks included."""
    return (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            miss=data.miss, device="cpu"),
            state_from_numpy(state, device="cpu"))


def em_cp():
    """tests/test_losses_missing.py::test_missing_data_em_cp's problem:
    20 % of a 12x13x14 CP tensor missing at random, set to 0."""
    spec = ProblemSpec(
        mode_sizes=(12, 13, 14),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0, distr=["rand", "randn", "randn"],
        rng=3)
    data, _ = normalize_data(spec, data)
    mask = np.random.default_rng(1).uniform(size=(12, 13, 14)) > 0.2
    X0 = np.asarray(data.objects[0])
    data = dataclasses.replace(
        data, objects=(jnp.asarray(np.where(mask, X0, 0.0)),),
        miss=(jnp.asarray(mask),))
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1),))
    return spec, data, init_coupled(spec, data, init, key=2)


def em_telemetry():
    """test_em_telemetry_uniform_across_fit_variants's problem (10x11x12)."""
    spec = ProblemSpec(
        mode_sizes=(10, 11, 12),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0, distr=["rand", "randn", "randn"],
        rng=3)
    data, _ = normalize_data(spec, data)
    mask = np.random.default_rng(1).uniform(size=(10, 11, 12)) > 0.2
    X0 = np.asarray(data.objects[0])
    data = dataclasses.replace(
        data, objects=(jnp.asarray(np.where(mask, X0, 0.0)),),
        miss=(jnp.asarray(mask),))
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1),))
    return spec, data, init_coupled(spec, data, init, key=2)


def em_par2():
    """test_missing_data_em_par2's problem: 15 % of 5 PARAFAC2 slices of
    9x11 missing at random."""
    K, J, I = 5, 11, 9
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, NN))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0,
        distr=["randn", "randn", "rand+0.1"], rng=3)
    data, _ = normalize_data(spec, data)
    mask = np.random.default_rng(4).uniform(size=(K, I, J)) > 0.15
    X = data.objects[0]
    slices = jnp.asarray(np.where(mask, np.asarray(X.slices), 0.0))
    data = dataclasses.replace(
        data, objects=(type(X)(slices=slices, mask=X.mask),),
        miss=(jnp.asarray(mask),))
    init = InitOptions(distr=("randn", "randn", "rand+0.1"), normalize=True,
                       lambdas_init=((1, 1),))
    return spec, data, init_coupled(spec, data, init, key=2)


def em_par2_ragged():
    """Ragged PARAFAC2 slices (J_k 9, 7, 9, 6, 8) with 20 % of the entries
    missing, the padded columns marked missing too (their imputation must
    stay exactly zero), non-negative A and C."""
    sizes, I, R = (9, 7, 9, 6, 8), 10, 3
    rng = np.random.default_rng(5)
    A = rng.uniform(size=(I, R))
    C = rng.uniform(0.5, 1.5, size=(len(sizes), R))
    X = Parafac2Tensor.from_list(
        [A @ np.diag(C[k]) @ rng.uniform(size=(J, R)).T
         for k, J in enumerate(sizes)])
    mask = rng.uniform(size=X.slices.shape) > 0.2
    mask &= np.asarray(X.mask)[:, None, :]
    spec = ProblemSpec(
        mode_sizes=(I, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, NN))
    from matlab_code_tpu.problem import ProblemData
    data = ProblemData(
        objects=(Parafac2Tensor(
            jnp.asarray(np.where(mask, np.asarray(X.slices), 0.0)), X.mask),),
        miss=(jnp.asarray(mask),), coupl_trafo=(None,) * 3,
        coupl_trafo2=(None,) * 3)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
    return spec, data, init_coupled(spec, data, init, key=3)


CASES = {"cp": em_cp, "par2": em_par2, "par2_ragged": em_par2_ragged}


def _dense(X):
    return np.asarray(X.slices if hasattr(X, "slices") else X)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_em_impute_and_masked_objective_match_jax(case):
    """From the same state: the data constants (a PARAFAC2 one masked),
    the masked objective streams, em_impute's data and f_rel_missing, and
    the masked objective of the imputed data, against the JAX functions at
    rtol 1e-12; the ragged dataset's padded columns stay exactly zero."""
    spec, data, state = CASES[case]()
    tspec, tdata, tstate = to_port(spec, data, state)
    jopts = AlgOptions()
    topts = options_from_reference(jopts)
    zj = jsolver.compute_znorm_consts(spec, data, jopts)
    zt = tsolver.compute_znorm_consts(tspec, tdata, topts)
    np.testing.assert_allclose([float(z) for z in zt], [float(z) for z in zj],
                               rtol=1e-13)
    grams_j, _ = jsolver.init_cache(spec, state)
    grams_t, _ = tsolver.init_cache(tspec, tstate)
    frms = []
    for _ in range(2):
        fj = jobjective.func_eval(spec, data, state, grams_j, zj, (None,) * 3,
                                  cached=None, options=jopts)
        ft = tobjective.func_eval(tspec, tdata, tstate, grams_t, zt,
                                  (None,) * 3, cached=None, options=topts)
        np.testing.assert_allclose([float(v) for v in ft],
                                   [float(v) for v in fj], rtol=1e-12,
                                   atol=1e-15)
        data, frm_j = jsolver.em_impute(spec, data, state)
        tdata, frm_t = tsolver.em_impute(tspec, tdata, tstate)
        np.testing.assert_allclose(_dense(tdata.objects[0]),
                                   _dense(data.objects[0]), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(float(frm_t), float(frm_j), rtol=1e-12)
        assert _dense(tdata.objects[0]).flags["C_CONTIGUOUS"]
        frms.append(float(frm_t))
    # the second imputation from the same state changes nothing
    assert frms[0] > 0 and frms[1] == 0
    if case == "par2_ragged":
        slices = tdata.objects[0].slices
        for k, J in enumerate(spec.mode_sizes[1]):
            assert not bool(slices[k, :, J:].any())


def test_torch_em_golden_cp_em_missing(monkeypatch):
    """The golden cp_em_missing (40 iterations, five streams with
    func_rel_missing) at the goldens' own rtol 1e-8."""
    spec, data, state0 = to_port(*_golden_problem("cp_em_missing",
                                                  monkeypatch))
    opts = tp.AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out = tp.fit(spec, data, state0, opts)
    traj = np.stack([getattr(out, s) for s in STREAMS])
    want = np.load(os.path.join(GOLDEN_DIR, "cp_em_missing.npz"))["traj"]
    assert np.isnan(traj[4, 0]) and np.isnan(want[4, 0])
    np.testing.assert_allclose(traj, want, rtol=1e-8, atol=1e-12)


def test_torch_em_znorm_consts_mask_par2():
    """compute_znorm_consts sums only a masked PARAFAC2 dataset's observed
    entries (the JAX rule, solver.py:94-96), also where the masked entries
    were not set to zero."""
    spec, data, _ = em_par2()
    X = data.objects[0]
    mask = np.asarray(data.miss[0])
    full = np.asarray(X.slices) + np.where(mask, 0.0, 1.0)
    data = dataclasses.replace(data, objects=(type(X)(
        slices=jnp.asarray(full), mask=X.mask),))
    tspec = spec_from_reference(spec)
    tdata = data_from_numpy(data.objects, miss=data.miss, device="cpu")
    got = float(tsolver.compute_znorm_consts(tspec, tdata, tp.AlgOptions())[0])
    want = float(jsolver.compute_znorm_consts(spec, data, AlgOptions())[0])
    np.testing.assert_allclose(got, want, rtol=1e-14)
    np.testing.assert_allclose(got, np.sum(np.where(mask, full, 0.0) ** 2),
                               rtol=1e-14)
    assert got < np.sum(full ** 2)


def test_torch_em_script12_reference_seeded_replay(monkeypatch):
    """Example script 12's MATLAB-seeded replay (its data, randperm masks
    and init from the reference's twister stream) with the port's fit:
    the objective stream reproduces the pinned golden at rtol 1e-9, to the
    same exit, and the held-out recovery clears the script's FMS."""
    fit = {}

    def port_cmtf_aoadmm(spec, data, options, init=None, **kw):
        tspec, tdata, tinit = to_port(spec, data, init)
        state, out = tp.fit(tspec, tdata, tinit, options_from_reference(options))
        fit["miss"] = tdata.miss
        return tsolver.assemble_zhat(tspec, state), state, init, out

    monkeypatch.setattr(jsolver, "cmtf_aoadmm", port_cmtf_aoadmm)
    res = importlib.import_module(
        "examples.script12_cp_par2_em").run_reference(verbose=False)
    out = res["out"]
    assert isinstance(out, tsolver.FitOutput)
    assert all(m is not None for m in fit["miss"])
    assert out.exit_flag != "maxIterations"
    want = np.load(os.path.join(GOLDEN_DIR, "reference_seeded_script12.npz"))
    np.testing.assert_allclose(out.func_val_conv, want["func_val_conv"],
                               rtol=1e-9, atol=1e-12)
    scores = [s for rep in res["report"].values() for s in rep[1:]]
    assert min(scores) > 0.99, res["report"]


def test_torch_em_workload_masks():
    """utils/em_workload.py: about 20 % of every dataset missing, those
    entries 0, a PARAFAC2 dataset's padded columns observed, the same mask
    from the same seed; script 12's widths fit with EM on the CPU."""
    import torch
    from matlab_code_tpu_torch.utils import em_workload as emw
    _, data = emw.build_par2("cpu", torch.float64, K=4)
    (mask,), (X,) = data.miss, data.objects
    assert mask.shape == X.slices.shape and mask.dtype == torch.bool
    assert abs(1 - float(mask.double().mean()) - emw.MISS_FRACTION) < 0.01
    assert not bool(X.slices[~mask].any())
    assert torch.equal(emw.build_par2("cpu", torch.float64, K=4)[1].miss[0],
                       mask)
    ragged = tp.Parafac2Tensor.from_list(
        [np.ones((3, J)) for J in (4, 2, 3)], device="cpu")
    (pm,) = emw.add_missing(tp.ProblemData(objects=(ragged,))).miss
    assert bool(pm[1, :, 2:].all()) and bool(pm[2, :, 3:].all())
    spec, data, opts, init = emw.script12_problem("cpu", torch.float64)
    assert all(m is not None for m in data.miss)
    state = tp.init_coupled(spec, data, init, seed=2)
    _, out = tp.fit(spec, data, state, tp.AlgOptions(
        MaxOuterIters=3, AbsFuncTol=0.0, OuterRelTol=0.0))
    assert out.OuterIterations == 3
    assert np.all(np.isfinite(out.func_rel_missing[1:]))
