"""The port's fit_multistart on sparse COO data, on the CPU in float64:
against the JAX package's fit_multistart on an 8 x 9 x 10 rank-2 tensor
(half of a non-negative CP tensor's entries kept, every mode
non-negative), 2 starts over a fixed 30 iterations; the sparse
objective (func_eval's MTTKRP branch) on the start axis against one call
a start; and keys=[k, ...] against sequential cmtf_aoadmm(..., seed=k)
fits from the port's own (nvecs-free) inits."""
import numpy as np
import pytest
import torch
import jax

from matlab_code_tpu import (
    AlgOptions, ConstraintSpec, CouplingSpec, DatasetSpec, InitOptions,
    ProblemSpec)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.multistart import fit_multistart
from matlab_code_tpu.problem import ProblemData, SparseTensor as JSparseTensor

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy)
from matlab_code_tpu_torch.models.multistart import _fit_lanes, _stack, _dims
from matlab_code_tpu_torch.models.objective import func_eval
from matlab_code_tpu_torch.models.solver import (
    build_proxes, compute_znorm_consts, init_cache)
from matlab_code_tpu_torch.state import SolverState

NN = ConstraintSpec("non-negativity")
STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl")


def _problem():
    rng = np.random.default_rng(8)
    shape = (8, 9, 10)
    dense = np.einsum("ir,jr,kr->ijk",
                      *(rng.uniform(size=(d, 2)) for d in shape))
    dense[rng.uniform(size=shape) > 0.5] = 0.0
    spec = ProblemSpec(
        mode_sizes=shape,
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN,) * 3)
    data = ProblemData(objects=(JSparseTensor.from_dense(dense),),
                       coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1, 1),))
    return spec, data, init


@pytest.fixture(scope="module")
def runs():
    spec, data, init = _problem()
    opts = AlgOptions(MaxOuterIters=30, AbsFuncTol=0.0, OuterRelTol=0.0)
    ref = fit_multistart(spec, data, opts, init, n_starts=2, base_key=0)
    root = jax.random.PRNGKey(0)
    states = [state_from_numpy(init_coupled(
        spec, data, init, key=jax.random.fold_in(root, s)), device="cpu")
        for s in range(2)]
    tspec = spec_from_reference(spec)
    tdata = data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu")
    return ref, _fit_lanes(tspec, tdata, states, options_from_reference(
        opts)), (tspec, tdata, states)


def test_torch_multistart_sparse_matches_jax(runs):
    """The stop iterations, the finals and the best start's streams at
    rtol 1e-8, its innerIters, and every factor of the best state within
    1e-8."""
    (rstate, rout, rfinals, rstops), lanes, (_, tdata, _) = runs
    assert isinstance(tdata.objects[0], tp.SparseTensor)
    state, out, finals, stops = lanes.best()
    assert list(stops) == [int(s) for s in rstops]
    np.testing.assert_allclose(finals, rfinals, rtol=1e-8)
    for s in STREAMS:
        np.testing.assert_allclose(getattr(out, s), getattr(rout, s),
                                   rtol=1e-8, atol=1e-14, err_msg=s)
    np.testing.assert_array_equal(out.innerIters, rout.innerIters)
    assert out.lbfgsb_iterations is None and rout.lbfgsb_iterations is None
    for a, b in zip(state.fac, rstate.fac):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-12)


def test_torch_sparse_objective_on_the_start_axis(runs):
    """func_eval's sparse MTTKRP branch (no cached MTTKRP) under the vmap
    of the start axis against one call a start."""
    _, _, (spec, data, states) = runs
    znorms = compute_znorm_consts(spec, data, tp.AlgOptions())
    _, reg_fns = build_proxes(spec)
    flat = _stack(states)

    def one(fl):
        state = SolverState(*fl)
        grams, _ = init_cache(spec, state)
        return torch.stack(func_eval(spec, data, state, grams, znorms,
                                     reg_fns, None, tp.AlgOptions()))
    got = torch.func.vmap(one, in_dims=(_dims(flat),))(flat)
    for s, st in enumerate(states):
        grams, _ = init_cache(spec, st)
        want = torch.stack(func_eval(spec, data, st, grams, znorms, reg_fns,
                                     None, tp.AlgOptions()))
        np.testing.assert_allclose(got[s].numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-15)


def test_torch_multistart_sparse_keys_are_sequential_fits(runs):
    """keys=[3, 4] on the sparse data: each start's final is the
    sequential cmtf_aoadmm(..., seed=k) fit's (the port's init_coupled,
    no nvecs)."""
    _, _, (spec, data, _) = runs
    opts = tp.AlgOptions(MaxOuterIters=8, AbsFuncTol=0.0, OuterRelTol=0.0)
    init = tp.InitOptions(distr=("rand",) * 3, normalize=True,
                          lambdas_init=((1, 1),))
    _, _, finals, _ = tp.fit_multistart(spec, data, opts, init, 2,
                                        keys=[3, 4])
    for s, k in enumerate((3, 4)):
        _, _, _, out = tp.cmtf_aoadmm(spec, data, opts, init_options=init,
                                      seed=k)
        np.testing.assert_allclose(finals[s], out.f_tensors, rtol=1e-12)
