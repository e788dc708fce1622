"""The port's fit against the JAX package under fit options (continued
from test_torch_solver.py): cp_pairwise_perturbation where a dataset is
eligible and where none is, and ridge and BSUM.

Everything runs in float64 on the CPU.
"""
import numpy as np
import pytest

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import options_from_reference, state_to_numpy
from matlab_code_tpu_torch.models.solver import fit as tfit
from test_torch_solver import _jax_problem, _to_port


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
