"""The port's fit against the JAX package (continued from
test_torch_solver.py): the small three-dataset type-4 problem through both
fits, the port's entry point from its own init, and the MATLAB-seeded
replays of example scripts 3, 5, 6, 10 and 13 with the port doing the fit.

Everything runs in float64 on the CPU.
"""
import os

import numpy as np
import pytest
import torch

from matlab_code_tpu import AlgOptions
from matlab_code_tpu.models.solver import fit

import __graft_entry__ as ge
import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models.solver import fit as tfit
from test_torch_solver import GOLDEN_DIR, _to_port


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
