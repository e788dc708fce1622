"""The port's fit against the JAX package: the pinned golden trajectories
of the coupled CP configurations, and the small three-dataset type-4
problem run through both fits.

Data and init state come from the JAX package and cross to the port as
numpy arrays (matlab_code_tpu_torch.convert); everything runs in float64 on
the CPU.
"""
import os

import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import __graft_entry__ as ge
import bench
import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models.solver import fit as tfit
from matlab_code_tpu_torch.utils import flagship

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _golden_config(name):
    """The specs of tests/test_golden_trajectories.py for the coupled CP
    goldens this slice covers."""
    NN = ConstraintSpec("non-negativity")
    if name == "cp_nonneg_coupled":
        spec = ProblemSpec(
            mode_sizes=(10, 11, 12, 10, 13),
            datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                                  weight=0.5),
                      DatasetSpec(model="CP", modes=(3, 4), rank=2,
                                  weight=0.5)),
            coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                                  coupling_type=(0,)),
            constraints=(NN, None, None, NN, None))
        return spec, None
    spec = ProblemSpec(
        mode_sizes=(11, 11, 12, 11, 13),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN, None, None, NN, None))
    trafo = [np.eye(3), None, None, np.vstack([np.eye(2), np.zeros((1, 2))]),
             None]
    return spec, trafo


def _jax_problem(name):
    spec, trafo = _golden_config(name)
    lambdas = [[1] * ds.rank for ds in spec.datasets]
    data, _, _, _ = create_coupled_data(
        spec, lambdas=lambdas, noise=0.05,
        distr=["rand", "randn", "randn", "rand", "randn"], rng=11,
        coupl_trafo=trafo)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "randn", "rand", "randn"),
                       normalize=True,
                       lambdas_init=tuple(tuple(l) for l in lambdas))
    return spec, data, init_coupled(spec, data, init, key=7)


def _to_port(spec, data, state):
    return (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            state_from_numpy(state, device="cpu"))


class _AtFit(Exception):
    """Raised in place of the JAX fit, carrying its spec, data and state."""


def _golden_problem(name, monkeypatch):
    """The spec, data and init state of a golden of
    tests/test_golden_trajectories.py, taken from its _run_config where it
    would call the JAX fit (so the configuration is that file's own)."""
    import test_golden_trajectories as gt

    def at_fit(spec, data, state0, opts):
        raise _AtFit(spec, data, state0)

    monkeypatch.setattr(gt, "fit", at_fit)
    with pytest.raises(_AtFit) as caught:
        gt._run_config(name)
    return caught.value.args


@pytest.mark.parametrize("name", [
    "cp_nonneg_coupled", "coupled_type4", "coupled_type1", "coupled_type2",
    "coupled_type3", "coupled_type5", "cp_tv"])
def test_torch_fit_reproduces_golden(name, monkeypatch):
    if name in ("cp_nonneg_coupled", "coupled_type4"):
        spec, data, state0 = _to_port(*_jax_problem(name))
    else:
        spec, data, state0 = _to_port(*_golden_problem(name, monkeypatch))
    opts = tp.AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out = tfit(spec, data, state0, opts)
    traj = np.stack([out.func_val_conv, out.func_coupl_conv,
                     out.func_constr_conv, out.func_PAR2_coupl])
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["traj"]
    # the goldens' own tolerance (tests/test_golden_trajectories.py)
    np.testing.assert_allclose(traj, want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("dimension_tree", [False, True])
def test_torch_fit_matches_jax_type4_three_datasets(dimension_tree):
    """__graft_entry__._type4_problem: the bench flagship's structure (three
    datasets, type-4 selector coupling, all modes non-negative), small;
    also with the dimension-tree MTTKRP partials (cp_dimension_tree)."""
    spec, data, state0 = ge._type4_problem(1)
    opts = AlgOptions(MaxOuterIters=5, AbsFuncTol=0.0, OuterRelTol=0.0,
                      cp_dimension_tree=dimension_tree)
    st_ref, out_ref = fit(spec, data, state0, opts)
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    st, out = tfit(tspec, tdata, tstate0, options_from_reference(opts))
    got = state_to_numpy(st)
    for m in range(spec.nb_modes):
        np.testing.assert_allclose(got["fac"][m], np.asarray(st_ref.fac[m]),
                                   rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got["coupling_fac"][0],
                               np.asarray(st_ref.coupling_fac[0]),
                               rtol=1e-10, atol=1e-13)
    for a, b in [(out.func_val_conv, out_ref.func_val_conv),
                 (out.func_coupl_conv, out_ref.func_coupl_conv),
                 (out.func_constr_conv, out_ref.func_constr_conv),
                 (out.func_PAR2_coupl, out_ref.func_PAR2_coupl)]:
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    np.testing.assert_array_equal(out.innerIters, out_ref.innerIters)
    assert out.OuterIterations == out_ref.OuterIterations == 5
    assert out.exit_flag == out_ref.exit_flag == "maxIterations"
    assert out.time_at_it.shape == (6,)
    assert np.all(np.diff(out.time_at_it) >= 0)


def test_torch_flagship_is_bench_workload():
    """utils/flagship.py rebuilds bench.py's flagship without jax: the same
    sizes, ranks, selectors and ground truth, assembled contiguous and
    normalised."""
    assert (flagship.S, flagship.RTOT, flagship.R1, flagship.R2, flagship.R3,
            flagship.N_ITERS) == (bench.S, bench.RTOT, bench.R1, bench.R2,
                                  bench.R3, bench.N_ITERS)
    (H, Delta, f) = flagship._flagship_truth(np.float64)
    (Hb, Deltab, fb) = bench._flagship_truth()
    for a, b in zip(H, Hb):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(Delta, Deltab)
    assert f.keys() == fb.keys()
    for m in f:
        np.testing.assert_array_equal(f[m], fb[m])
    spec, data = flagship.build_problem("cpu", torch.float32)
    assert spec.mode_sizes == (128, 512, 256, 128, 1024, 64, 128, 4096)
    assert [ds.rank for ds in spec.datasets] == [16, 20, 20]
    assert spec.coupling.coupling_type == (4,)
    for X in data.objects:
        assert X.is_contiguous() and X.dtype == torch.float32
        assert abs(float(torch.linalg.norm(X)) - 1.0) < 1e-5
    tp.check_data_input(spec, data)


def test_torch_cmtf_aoadmm_from_its_own_init():
    """The port's entry point end to end on the CPU: init_coupled draws from
    an explicit torch.Generator (the same seed gives the same state), the
    fit lowers the objective and Zhat has the datasets' factor shapes."""
    spec = tp.ProblemSpec(
        mode_sizes=(12, 2, 9, 12, 3, 5, 12, 4),
        datasets=(tp.DatasetSpec("CP", (0, 1, 2), 3, weight=1 / 3),
                  tp.DatasetSpec("CP", (3, 4, 5), 3, weight=1 / 3),
                  tp.DatasetSpec("CP", (6, 7), 2, weight=1 / 3)),
        coupling=tp.CouplingSpec((1, 0, 0, 1, 0, 0, 1, 0), (4,)),
        constraints=(tp.ConstraintSpec("non-negativity"),) * 8)
    _, jdata, _ = ge._type4_problem(1)
    data = data_from_numpy(jdata.objects, jdata.coupl_trafo, jdata.coupl_trafo2,
                           device="cpu")
    init = tp.InitOptions(distr=("rand",) * 8, normalize=True)
    a = tp.init_coupled(spec, data, init, seed=4)
    b = tp.init_coupled(spec, data, init, seed=4)
    for x, y in zip(state_to_numpy(a)["fac"], state_to_numpy(b)["fac"]):
        np.testing.assert_array_equal(x, y)
    assert a.coupling_fac[0].shape == (12, 4)
    assert all(float(z.min()) >= 0 for z in a.constraint_fac)
    opts = tp.AlgOptions(MaxOuterIters=30, AbsFuncTol=0.0, OuterRelTol=0.0)
    zhat, state, state0, out = tp.cmtf_aoadmm(
        spec, data, opts, init_options=init,
        generator=torch.Generator().manual_seed(4))
    assert state0.fac[0].shape == (12, 3)
    np.testing.assert_array_equal(state0.fac[0].numpy(), a.fac[0].numpy())
    assert out.OuterIterations == 30 and out.exit_flag == "maxIterations"
    assert out.func_val_conv[-1] < 0.1 * out.func_val_conv[0]
    assert [[f.shape for f in z["factors"]] for z in zhat] == [
        [(12, 3), (2, 3), (9, 3)], [(12, 3), (3, 3), (5, 3)],
        [(12, 2), (4, 2)]]
    with pytest.raises(ValueError, match="init_options"):
        tp.cmtf_aoadmm(spec, data, opts)


@pytest.mark.parametrize("mod,noise_fms", [
    ("script06_three_datasets", 0.99),
    ("script03_matrix_cp_partialcoupling", 0.99),
    ("script05_cp_cp_doublesampling_simplex", 0.99),
    ("script10_cp_tv", 0.99),
    ("script13_cp_cp_type5", 0.999)])
def test_torch_reference_seeded_replays(mod, noise_fms, monkeypatch):
    """The MATLAB-seeded replays of example scripts 6 (type 0, three
    datasets), 3 (type 4, partial coupling), 5 (type 1, double sampling
    rate, column-wise simplex), 10 (TV and l2-ball) and 13 (type 5) with
    the port doing the fit: the data and init come from the reference's
    exact twister stream
    (examples/common.run_reference_seeded), the port's cmtf_aoadmm stands
    in for the JAX package's, and the result must recover the truth and
    reproduce the pinned golden (tests/test_fixture_parity.py's tolerance)."""
    import importlib
    import matlab_code_tpu.models.solver as jsolver

    def port_cmtf_aoadmm(spec, data, options, init=None, **kw):
        return tp.cmtf_aoadmm(
            spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo,
                            data.coupl_trafo2, device="cpu"),
            options_from_reference(options),
            init=state_from_numpy(init, device="cpu"))

    monkeypatch.setattr(jsolver, "cmtf_aoadmm", port_cmtf_aoadmm)
    res = importlib.import_module(f"examples.{mod}").run_reference(
        verbose=False)
    assert isinstance(res["out"], tp.models.solver.FitOutput)
    scores = [s for rep in res["report"].values() for s in rep[1:]]
    assert min(scores) > noise_fms, res["report"]
    assert res["out"].exit_flag != "maxIterations"
    ref = np.load(os.path.join(GOLDEN_DIR, f"reference_seeded_"
                               f"{mod.split('_')[0]}.npz"))["func_val_conv"]
    np.testing.assert_allclose(res["out"].func_val_conv, ref, rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_torch_fit_pairwise_perturbation_raises_where_eligible(layout):
    """cp_pairwise_perturbation on a 3-way CP dataset with Frobenius loss
    (dense or COO), which raised until the pairwise-perturbation MTTKRP
    was ported: the dataset is eligible, and the port's fit follows the
    JAX fit with the same flag (8 iterations, before the approximation
    switches on, plus the exact final objective)."""
    jspec, jdata, jstate0 = _jax_problem("cp_nonneg_coupled")
    if layout == "sparse":
        from matlab_code_tpu.problem import SparseTensor as JSparseTensor
        import dataclasses
        jdata = dataclasses.replace(jdata, objects=(
            JSparseTensor.from_dense(np.asarray(jdata.objects[0])),)
            + tuple(jdata.objects[1:]))
    spec, data, state0 = _to_port(jspec, jdata, jstate0)
    from matlab_code_tpu_torch.models.pairwise import eligible_pp_datasets
    opts = AlgOptions(MaxOuterIters=8, AbsFuncTol=0.0, OuterRelTol=0.0,
                      cp_pairwise_perturbation=True)
    topts = options_from_reference(opts)
    assert eligible_pp_datasets(spec, data, topts) == (0,)
    assert eligible_pp_datasets(spec, data, tp.AlgOptions()) == ()
    _, out_ref = fit(jspec, jdata, jstate0, opts)
    _, out = tfit(spec, data, state0, topts)
    for a, b in [(out.func_val_conv, out_ref.func_val_conv),
                 (out.func_coupl_conv, out_ref.func_coupl_conv),
                 (out.func_constr_conv, out_ref.func_constr_conv)]:
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-14)
    np.testing.assert_array_equal(out.innerIters, out_ref.innerIters)


def test_torch_fit_pairwise_perturbation_without_eligible_dataset():
    """cp_pairwise_perturbation on a problem with no 3-way CP dataset (two
    coupled matrices): neither package takes the pairwise path, and the
    port's fit matches the JAX fit with the same flag."""
    NN = ConstraintSpec("non-negativity")
    spec = ProblemSpec(
        mode_sizes=(10, 11, 10, 12),
        datasets=(DatasetSpec(model="CP", modes=(0, 1), rank=2),
                  DatasetSpec(model="CP", modes=(2, 3), rank=2)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=(NN, None, NN, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1], [1, 1]], noise=0.05,
        distr=["rand", "randn", "rand", "randn"], rng=3)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "rand", "randn"), normalize=True,
                       lambdas_init=((1, 1), (1, 1)))
    state0 = init_coupled(spec, data, init, key=2)
    opts = AlgOptions(MaxOuterIters=8, AbsFuncTol=0.0, OuterRelTol=0.0,
                      cp_pairwise_perturbation=True)
    _, out_ref = fit(spec, data, state0, opts)
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    topts = options_from_reference(opts)
    assert topts.cp_pairwise_perturbation
    _, out = tfit(tspec, tdata, tstate0, topts)
    for a, b in [(out.func_val_conv, out_ref.func_val_conv),
                 (out.func_coupl_conv, out_ref.func_coupl_conv),
                 (out.func_constr_conv, out_ref.func_constr_conv)]:
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-14)
    assert out.OuterIterations == out_ref.OuterIterations == 8


@pytest.mark.parametrize("ridge,bsum", [((0.05, 0.0, 0.02), False),
                                        (None, True), (None, False)])
def test_torch_fit_matches_jax_ridge_bsum(ridge, bsum):
    """Ridge on two modes (one of them unconstrained) and BSUM, each alone,
    and neither: test_oracle_parity_ridge_bsum's problem through the port
    and the JAX fit from one init state, 12 outer iterations."""
    spec = ProblemSpec(
        mode_sizes=(8, 9, 10),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None,
                     ConstraintSpec("non-negativity")),
        ridge=ridge)
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.05, distr=["rand", "randn", "rand"],
        rng=6)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "rand"), normalize=True,
                       lambdas_init=((1, 1),))
    state0 = init_coupled(spec, data, init, key=5)
    opts = AlgOptions(MaxOuterIters=12, AbsFuncTol=0.0, OuterRelTol=0.0,
                      bsum=bsum, bsum_weight=1e-3)
    st_ref, out_ref = fit(spec, data, state0, opts)
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    assert tspec.ridge == ridge
    st, out = tfit(tspec, tdata, tstate0, options_from_reference(opts))
    for a, b in [(out.func_val_conv, out_ref.func_val_conv),
                 (out.func_constr_conv, out_ref.func_constr_conv)]:
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    got = state_to_numpy(st)
    for m in range(3):
        np.testing.assert_allclose(got["fac"][m], np.asarray(st_ref.fac[m]),
                                   rtol=1e-9, atol=1e-12)
