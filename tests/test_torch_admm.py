"""The port's inner ADMM loops, small solves, proxes, precompute and
objective against the JAX package on identical float64 inputs."""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models import admm as jadmm
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.objective import func_eval as jfunc_eval
from matlab_code_tpu.models.solver import (
    build_proxes as jbuild_proxes, init_cache as jinit_cache,
    compute_znorm_consts as jznorms)
from matlab_code_tpu.models.updates import cp_mode_precompute as jprecompute
from matlab_code_tpu.ops import linalg as jlinalg
from matlab_code_tpu.ops import prox as jprox
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, spec_from_reference, state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models import admm as tadmm
from matlab_code_tpu_torch.models.objective import func_eval as tfunc_eval
from matlab_code_tpu_torch.models.solver import (
    build_proxes as tbuild_proxes, init_cache as tinit_cache,
    compute_znorm_consts as tznorms)
from matlab_code_tpu_torch.models.updates import cp_mode_precompute as tprecompute
from matlab_code_tpu_torch.ops import linalg as tlinalg
from matlab_code_tpu_torch.ops import prox as tprox
from matlab_code_tpu_torch.options import apply_matmul_precision

RTOL = 1e-10


def _problem():
    """Three CP datasets (two 3-way, one matrix) coupled on their first
    modes by a type-4 selector coupling, all modes non-negative: the bench
    flagship's structure at a small size."""
    NN = ConstraintSpec("non-negativity")
    spec = ProblemSpec(
        mode_sizes=(10, 6, 7, 10, 5, 4, 10, 9),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=1 / 3),
                  DatasetSpec(model="CP", modes=(3, 4, 5), rank=2, weight=1 / 3),
                  DatasetSpec(model="CP", modes=(6, 7), rank=2, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN,) * 8)
    H1 = np.eye(4, 3)
    H2 = np.zeros((4, 2))
    H2[[1, 3], [0, 1]] = 1.0
    H3 = np.eye(4, 2)
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1] * 3, [1] * 2, [1] * 2], noise=0.05,
        distr=["rand"] * 8, coupl_trafo=[H1, None, None, H2, None, None, H3,
                                         None], rng=3)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand",) * 8, normalize=True)
    state = init_coupled(spec, data, init, key=5)
    tdata = data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu")
    return spec, data, state, spec_from_reference(spec), tdata, \
        state_from_numpy(state, device="cpu")


def _close(a, b, rtol=RTOL, atol=1e-14):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _assert_states_close(tstate, jstate):
    got = state_to_numpy(tstate)
    for field, vals in got.items():
        for a, b in zip(vals, getattr(jstate, field)):
            assert (a is None) == (b is None), field
            if a is not None:
                _close(a, b)


def test_torch_cp_mode_precompute_matches_jax():
    spec, data, state, tspec, tdata, tstate = _problem()
    opts = AlgOptions()
    jgrams, _ = jinit_cache(spec, state)
    tgrams, _ = tinit_cache(tspec, tstate)
    for m in (1, 2, 7):   # 3-way modes and a matrix mode
        p = spec.which_p(m)
        jp = jprecompute(spec, data, state, jgrams, p, m, opts)
        tpre = tprecompute(tspec, tdata, tstate, tgrams, p, m, tp.AlgOptions())
        for a, b in zip(tpre, jp):
            _close(a, b)


def test_torch_admm_constrained_only_matches_jax():
    spec, data, state, tspec, tdata, tstate = _problem()
    m, p = 1, 0
    opts = AlgOptions(MaxInnerIters=5)
    jgrams, _ = jinit_cache(spec, state)
    pre = jprecompute(spec, data, state, jgrams, p, m, opts)
    Bmat = pre.B + 0.5 * pre.rho * jnp.eye(3)
    jsolve, _, _ = jadmm.make_spd_solver(Bmat, opts, illtol=opts.IllCondTol)
    jproxes, _ = jbuild_proxes(spec)
    jst, jnin, _, _ = jadmm.admm_constrained_only(
        spec, state, m, p, pre.A, jsolve, pre.rho, opts, jproxes)

    topts = tp.AlgOptions(MaxInnerIters=5)
    tsolve, _, tillc = tadmm.make_spd_solver(
        torch.tensor(np.asarray(Bmat)), topts, illtol=topts.IllCondTol)
    assert not bool(tillc)
    tproxes, _ = tbuild_proxes(tspec)
    tst, tnin, _, _ = tadmm.admm_constrained_only(
        tspec, tstate, m, p, torch.tensor(np.asarray(pre.A)), tsolve,
        torch.tensor(float(pre.rho), dtype=torch.float64), topts, tproxes)
    assert tnin == int(jnin)
    _assert_states_close(tst, jst)


@pytest.mark.parametrize("inner_solve", ["chol", "inverse"])
def test_torch_admm_coupled_type4_matches_jax(inner_solve):
    spec, data, state, tspec, tdata, tstate = _problem()
    cmodes = spec.coupled_modes_of(1)
    opts = AlgOptions(MaxInnerIters=5, inner_solve=inner_solve)
    topts = tp.AlgOptions(MaxInnerIters=5, inner_solve=inner_solve)
    jgrams, _ = jinit_cache(spec, state)
    jproxes, _ = jbuild_proxes(spec)
    tproxes, _ = tbuild_proxes(tspec)
    As, rhos, solvers, tAs, trhos, tsolvers = {}, {}, {}, {}, {}, {}
    for m in cmodes:
        pre = jprecompute(spec, data, state, jgrams, spec.which_p(m), m, opts)
        R = spec.mode_rank(m)
        B = pre.B + pre.rho * jnp.eye(R)   # coupled + constrained: two rho/2 I
        As[m], rhos[m] = pre.A, pre.rho
        solvers[m], _, _ = jadmm.make_spd_solver(B, opts,
                                                 illtol=opts.IllCondTol)
        tAs[m] = torch.tensor(np.asarray(pre.A))
        trhos[m] = torch.tensor(float(pre.rho), dtype=torch.float64)
        tsolvers[m], _, _ = tadmm.make_spd_solver(
            torch.tensor(np.asarray(B)), topts, illtol=topts.IllCondTol)
    jst, jnin, _, _ = jadmm.admm_coupled(
        spec, state, data, cmodes, 1, 4, As, {m: None for m in cmodes}, {}, {},
        rhos, opts, jproxes, solvers=solvers)
    tst, tnin, _, _ = tadmm.admm_coupled(
        tspec, tstate, tdata, cmodes, 1, 4, tAs, trhos, topts, tproxes,
        tsolvers)
    assert tnin == int(jnin)
    _assert_states_close(tst, jst)


def test_torch_cholesky_of_non_pd_flags_and_does_not_raise():
    B = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)  # eig -1, 3
    L = tlinalg.chol_lower(B)
    assert torch.isnan(L).all()
    assert bool(tadmm._chol_rcond_bad(L, 1e-16))
    _, _, illc = tadmm.make_spd_solver(B, tp.AlgOptions(), illtol=1e-16)
    assert bool(illc)
    # the JAX package flags the same matrix
    assert bool(jadmm._chol_rcond_bad(jlinalg.chol_lower(jnp.asarray(B.numpy())),
                                      1e-16))
    good = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    _, _, illc = tadmm.make_spd_solver(good, tp.AlgOptions(), illtol=1e-16)
    assert not bool(illc)


def test_torch_small_solves_match_jax():
    rng = np.random.default_rng(6)
    M = rng.standard_normal((4, 4))
    B = M @ M.T + 4 * np.eye(4)
    A = rng.standard_normal((7, 4))
    G = rng.standard_normal((4, 4)) + 3 * np.eye(4)
    jL = jlinalg.chol_lower(jnp.asarray(B))
    tL = tlinalg.chol_lower(torch.tensor(B))
    _close(tL, jL, rtol=1e-13)
    _close(tlinalg.solve_with_chol(tL, torch.tensor(A)),
           jlinalg.solve_with_chol(jL, jnp.asarray(A)), rtol=1e-12)
    _close(tlinalg.solve_spd_left(tL, torch.tensor(A.T)),
           jlinalg.solve_spd_left(jL, jnp.asarray(A.T)), rtol=1e-12)
    _close(tlinalg.spd_inverse_from_chol(tL),
           jlinalg.spd_inverse_from_chol(jL), rtol=1e-12)
    _close(tlinalg.rsolve(torch.tensor(A), torch.tensor(G)),
           jlinalg.rsolve(jnp.asarray(A), jnp.asarray(G)), rtol=1e-12)


@pytest.mark.parametrize("kind,params", [
    ("non-negativity", ()), ("box", (-0.2, 0.3)),
    ("non-negative l2-sphere", ())])
def test_torch_prox_matches_jax(kind, params):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 4))
    x[:, 2] = -np.abs(x[:, 2])   # an all-negative column
    jp, _ = jprox.make_prox(jprox.ConstraintSpec(kind, params), 6)
    tpx, _ = tprox.make_prox(tprox.ConstraintSpec(kind, params), 6)
    _close(tpx(torch.tensor(x), 1.0), jp(jnp.asarray(x), 1.0), rtol=1e-14)


def test_torch_unported_parts_raise_not_implemented():
    with pytest.raises(ValueError):
        tprox.ConstraintSpec("no such constraint")
    spec = tp.ProblemSpec(
        mode_sizes=(4, 5, 4, 6),
        datasets=(tp.DatasetSpec("CP", (0, 1), 2),
                  tp.DatasetSpec("CP", (2, 3), 2, loss="KL")),
        coupling=tp.CouplingSpec((1, 0, 1, 0), (3,)))
    X = torch.ones((4, 5), dtype=torch.float64)
    data = tp.ProblemData(objects=(X, torch.ones((4, 6), dtype=torch.float64)),
                          coupl_trafo=(torch.eye(4, dtype=torch.float64), None,
                                       torch.eye(4, dtype=torch.float64), None))
    # the KL fit that raised until slice 5 now runs (its L-BFGS-B steps
    # coupled by type 3 to a Frobenius dataset)
    state = tp.init_coupled(
        spec, data, tp.InitOptions(distr=("rand",) * 4, normalize=True,
                                   lambdas_init=((1, 1), (1, 1))),
        generator=torch.Generator().manual_seed(0))
    _, out = tp.fit(spec, data, state, tp.AlgOptions(MaxOuterIters=3))
    assert out.OuterIterations >= 1 and np.isfinite(out.f_tensors)
    assert out.lbfgsb_iterations.shape == (4, out.OuterIterations + 1)
    assert out.lbfgsb_iterations[2:, 1].min() >= 1
    assert out.lbfgsb_iterations[:2].max() == 0   # the Frobenius modes
    # missing data, which raised until slice 6, now runs (EM imputation):
    # a matrix with one entry missing
    miss = torch.ones((4, 5), dtype=torch.bool)
    miss[1, 2] = False
    _, out = tp.fit(tp.ProblemSpec(mode_sizes=(4, 5),
                                   datasets=(tp.DatasetSpec("CP", (0, 1), 2),)),
                    tp.ProblemData(objects=(torch.rand(
                        (4, 5), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(2)),),
                        miss=(miss,)),
                    tp.SolverState.empty(2, 0, 1).replace(
                        fac=(torch.rand((4, 2), dtype=torch.float64,
                                        generator=torch.Generator().manual_seed(0)),
                             torch.rand((5, 2), dtype=torch.float64,
                                        generator=torch.Generator().manual_seed(1)))),
                    tp.AlgOptions(MaxOuterIters=3, AbsFuncTol=0.0,
                                  OuterRelTol=0.0), validate=False)
    assert out.OuterIterations == 3 and np.isnan(out.func_rel_missing[0])
    assert np.all(np.isfinite(out.func_rel_missing[1:]))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        apply_matmul_precision(tp.AlgOptions(matmul_precision="bfloat16"))


@pytest.mark.parametrize("precision,tf32", [
    ("default", False), ("float32", False), ("highest", False),
    ("tensorfloat32", True)])
def test_torch_matmul_precision_sets_both_tf32_switches(precision, tf32):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        torch.backends.cudnn.allow_tf32 = not tf32
        apply_matmul_precision(tp.AlgOptions(matmul_precision=precision))
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_torch_func_eval_matches_jax_fresh_and_cached():
    spec, data, state, tspec, tdata, tstate = _problem()
    opts = AlgOptions()
    jgrams, _ = jinit_cache(spec, state)
    tgrams, _ = tinit_cache(tspec, tstate)
    _, jreg = jbuild_proxes(spec)
    _, treg = tbuild_proxes(tspec)
    jz = jznorms(spec, data, opts)
    tz = tznorms(tspec, tdata, tp.AlgOptions())
    for a, b in zip(tz, jz):
        _close(a, b, rtol=1e-13)
    got = tfunc_eval(tspec, tdata, tstate, tgrams, tz, treg)
    want = jfunc_eval(spec, data, state, jgrams, jz, jreg)
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-12)
    jcached, tcached = {}, {}
    for p, m in ((0, 2), (1, 5), (2, 7)):
        jp = jprecompute(spec, data, state, jgrams, p, m, opts)
        tpre = tprecompute(tspec, tdata, tstate, tgrams, p, m, tp.AlgOptions())
        local = spec.datasets[p].modes.index(m)
        jcached[p] = (jp.last_mttkrp, jp.last_had, local)
        tcached[p] = (tpre.last_mttkrp, tpre.last_had, local)
    got = tfunc_eval(tspec, tdata, tstate, tgrams, tz, treg, cached=tcached)
    want = jfunc_eval(spec, data, state, jgrams, jz, jreg, cached=jcached)
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-12)
    assert not math.isnan(float(got[0]))
