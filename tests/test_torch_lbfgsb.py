"""The port's L-BFGS-B host loop (matlab_code_tpu_torch/ops/lbfgsb.py)
against the JAX package's lax.while_loop version
(matlab_code_tpu/ops/lbfgsb.py) in float64 on the CPU, on the KL factor
subproblems of tests/test_lbfgsb_scipy.py's setup (a 15 x 10 x 12 KL
dataset after 5 outer iterations of the JAX fit): the same iterates to
rtol 1e-10 and the same iteration counts, also where the evaluation budget
max_total_its ends the loop, where it is done at the start and where the
box binds; and the device reads it makes (models/admm.to_host), one at the
start and one a line-search try."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    AlgOptions, CouplingSpec, DatasetSpec, InitOptions, ProblemSpec)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.ops import losses as jlosses
from matlab_code_tpu.ops.lbfgsb import lbfgsb as jlbfgsb
from matlab_code_tpu.ops.tensor import ktensor_full as jfull, mttkrp as jmttkrp
from matlab_code_tpu.options import LbfgsbOptions
from matlab_code_tpu.utils.datagen import create_coupled_data

from matlab_code_tpu_torch.models.admm import to_host
from matlab_code_tpu_torch.ops import losses as tlosses
from matlab_code_tpu_torch.ops.lbfgsb import lbfgsb as tlbfgsb
from matlab_code_tpu_torch.ops.tensor import ktensor_full, mttkrp

EPS_LOG = 1e-10


@functools.lru_cache(maxsize=1)
def _subproblems():
    """X and the factors after 5 outer iterations of the JAX fit
    (tests/test_lbfgsb_scipy.py's setup), as numpy arrays."""
    spec = ProblemSpec(
        mode_sizes=(15, 10, 12),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                              loss="KL"),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None,) * 3)
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0, distr=[("gamma", 2.0, 3.0)] * 3,
        rng=2)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1, 1),))
    state0 = init_coupled(spec, data, init, key=2)
    opts = AlgOptions(MaxOuterIters=5, AbsFuncTol=0.0, OuterRelTol=0.0,
                      lbfgsb=LbfgsbOptions(m=5, maxIts=100, pgtol=1e-8))
    state, _ = fit(spec, data, state0, opts)
    return (np.asarray(data.objects[0]),
            tuple(np.asarray(f) for f in state.fac))


def _jax_vag(m):
    X, facs = _subproblems()
    X = jnp.asarray(X)
    facs = [jnp.asarray(f) for f in facs]
    shape = facs[m].shape

    def vag(xvec):
        x = xvec.reshape(shape)
        fs = [f if j != m else x for j, f in enumerate(facs)]
        M = jfull(fs)
        f = jnp.sum(jlosses.loss_fh("KL", X, M, EPS_LOG))
        g = jmttkrp(jlosses.loss_gh("KL", X, M, EPS_LOG), fs, m)
        return f, g.reshape(-1)
    return vag, facs[m].reshape(-1)


def _torch_vag(m):
    """The same function in the port, counting its evaluations."""
    X, facs = _subproblems()
    X = torch.tensor(X)
    facs = [torch.tensor(f) for f in facs]
    shape = facs[m].shape

    def vag(xvec):
        vag.calls += 1
        x = xvec.reshape(shape)
        fs = [f if j != m else x for j, f in enumerate(facs)]
        f, Y = tlosses.loss_fg("KL", X, ktensor_full(fs), EPS_LOG)
        return f, mttkrp(Y, fs, m).reshape(-1)
    vag.calls = 0
    return vag, facs[m].reshape(-1)


def _run_both(mode, lower=0.0, upper=np.inf, **kw):
    jvag, jx0 = _jax_vag(mode)
    jres = jlbfgsb(jvag, jx0, lower, upper, **kw)
    tvag, tx0 = _torch_vag(mode)
    tl = torch.tensor(lower) if isinstance(lower, np.ndarray) else lower
    tu = torch.tensor(upper) if isinstance(upper, np.ndarray) else upper
    calls = to_host.calls
    tres = tlbfgsb(tvag, tx0, tl, tu, **kw)
    reads = to_host.calls - calls
    return jres, tres, tvag.calls, reads


def _check(jres, tres, evals, reads):
    assert tres.iterations == int(jres.iterations)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-12)
    tries = evals - 1
    # one read at the start, one a try: within tries + iterations, or the
    # start test alone where no iteration runs
    assert reads == 1 + tries
    assert reads <= tries + max(tres.iterations, 1)


@pytest.mark.parametrize("m", [0, 1, 2])
def test_torch_lbfgsb_matches_jax_on_kl_subproblems(m):
    """test_lbfgsb_scipy.py's maxiter 300 and pgtol 1e-9, with factr 1e3
    (its factr 10 stops where f changes by 10 eps |f|, ~8e-9 here, which
    is the rounding of the two packages' sums of fh in their own orders:
    there the last iteration is decided by rounding alone)."""
    jres, tres, evals, reads = _run_both(m, m=5, maxiter=300, pgtol=1e-9,
                                         factr=1e3)
    assert tres.iterations > 15
    _check(jres, tres, evals, reads)


@pytest.mark.parametrize("m,budget", [(0, 7), (2, 12)])
def test_torch_lbfgsb_stops_at_max_total_its(m, budget):
    """The evaluation budget, counted from 1 with every backtrack, ends the
    loop: the port stops after the same iteration, with at most budget +
    a last search's tries evaluations."""
    jres, tres, evals, reads = _run_both(m, m=5, maxiter=300, pgtol=1e-12,
                                         factr=0.0, max_total_its=budget)
    _check(jres, tres, evals, reads)
    assert tres.iterations < 300


def test_torch_lbfgsb_done_at_start():
    """pg_norm(x0, g0) <= pgtol: no iteration, x0 projected, one
    evaluation and one read."""
    jres, tres, evals, reads = _run_both(1, m=5, maxiter=300, pgtol=1e6)
    assert tres.iterations == 0 == int(jres.iterations)
    assert evals == 1 and reads == 1
    _check(jres, tres, evals, reads)


def test_torch_lbfgsb_binding_box():
    """An upper bound below the unconstrained minimizer's entries (a
    tensor bound): some entries end on it, as in the JAX loop."""
    _, facs = _subproblems()
    upper = np.full(facs[0].size, 0.6 * float(np.median(facs[0])))
    jres, tres, evals, reads = _run_both(0, lower=0.0, upper=upper, m=3,
                                         maxiter=200, pgtol=1e-10, factr=1e3)
    _check(jres, tres, evals, reads)
    at_upper = np.isclose(tres.x.numpy(), upper, rtol=0, atol=1e-12)
    assert at_upper.sum() >= 3


def test_torch_lbfgsb_runs_nothing_without_a_budget():
    """maxiter 0: the start test is not even read."""
    tvag, tx0 = _torch_vag(0)
    calls = to_host.calls
    res = tlbfgsb(tvag, -tx0, 0.0, np.inf, maxiter=0)
    assert to_host.calls == calls and res.iterations == 0 and tvag.calls == 1
    assert float(res.x.min()) == 0.0    # projected onto the box
