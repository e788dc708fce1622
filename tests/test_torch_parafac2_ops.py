"""The port's PARAFAC2 building blocks against the JAX package's, in float64
on the CPU from numpy-made inputs: the precomputes and the shared partial
W (updates.py), the polar factors, the Newton-Hotelling inverse and
block_diag (linalg.py), the K-batched solvers of make_spd_solver, the
tPARAFAC2 prox and penalty, and the slice-wise proxes on regular and
ragged slices with one rho a slice (admm.py), plus Parafac2Tensor and its
crossing through convert.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    AlgOptions, ConstraintSpec, CouplingSpec, DatasetSpec, ProblemSpec)
from matlab_code_tpu.models import admm as jadmm
from matlab_code_tpu.models import updates as jupd
from matlab_code_tpu.ops import linalg as jlinalg
from matlab_code_tpu.ops import prox as jprox
from matlab_code_tpu.problem import Parafac2Tensor, ProblemData
from matlab_code_tpu.state import SolverState

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, spec_from_reference, state_from_numpy)
from matlab_code_tpu_torch.models import admm as tadmm
from matlab_code_tpu_torch.models import updates as tupd
from matlab_code_tpu_torch.ops import linalg as tlinalg
from matlab_code_tpu_torch.ops import prox as tprox
from matlab_code_tpu_torch.problem import Parafac2Tensor as TParafac2Tensor

SIZES = (9, 7, 9, 6)
I, R = 8, 3


def _close(got, want, rtol, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _problem(seed=1, ridge=None):
    """A ragged PARAFAC2 dataset with a random state, in both packages."""
    rng = np.random.default_rng(seed)
    K, Jmax = len(SIZES), max(SIZES)
    slices = [rng.standard_normal((I, J)) for J in SIZES]
    spec = ProblemSpec(
        mode_sizes=(I, SIZES, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R,
                              weight=0.7),),
        coupling=CouplingSpec((0, 0, 0), ()),
        constraints=(None, ConstraintSpec("non-negativity"), None),
        ridge=ridge)
    data = ProblemData(objects=(Parafac2Tensor.from_list(slices),),
                       coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    Bs = np.zeros((K, Jmax, R))
    for k, J in enumerate(SIZES):
        Bs[k, :J] = rng.standard_normal((J, R))
    fac = (rng.standard_normal((I, R)), Bs, rng.uniform(0.5, 1.5, (K, R)))
    state = SolverState(fac=tuple(jnp.asarray(f) for f in fac),
                        constraint_fac=(None,) * 3,
                        constraint_dual_fac=(None,) * 3, coupling_fac=(),
                        coupling_dual_fac=(None,) * 3, P=(None,),
                        DeltaB=(None,), mu_DeltaB=(None,))
    tstate = state_from_numpy(state, device="cpu")
    return (spec, data, state, spec_from_reference(spec),
            data_from_numpy(data.objects, device="cpu"), tstate)


@pytest.mark.parametrize("bsum,ridge,active,factor", [
    (False, None, False, None), (True, (0.0, 0.3, 0.2), True, 10.0)])
def test_torch_par2_precomputes_match_jax(bsum, ridge, active, factor):
    """par2_gram_Bk, par2A/B/C_precompute (with ridge, BSUM, the active
    constraint's second rho/2 I and increase_factor_rhoBk) and the shared W,
    reused only while the A factor is the same object."""
    spec, data, state, tspec, tdata, tstate = _problem(ridge=ridge)
    opts = AlgOptions(bsum=bsum, bsum_weight=0.4, increase_factor_rhoBk=factor)
    topts = tp.AlgOptions(bsum=bsum, bsum_weight=0.4,
                          increase_factor_rhoBk=factor)
    grams = (jnp.asarray(state.fac[0]).T @ state.fac[0],
             jupd.par2_gram_Bk(state.fac[1]), None)
    tgrams = (tstate.fac[0].T @ tstate.fac[0],
              tupd.par2_gram_Bk(tstate.fac[1]), None)
    _close(tgrams[1], grams[1], 1e-12)
    ja = jupd.par2A_precompute(spec, data, state, grams, 0, 0, opts)
    ta = tupd.par2A_precompute(tspec, tdata, tstate, tgrams, 0, 0, topts)
    for t, j in zip(ta, ja):
        _close(t, j, 1e-10)
    partials, tpartials = {}, {}
    jb = jupd.par2B_precompute(spec, data, state, grams, 0, 1, opts, active,
                               partials)
    tb = tupd.par2B_precompute(tspec, tdata, tstate, tgrams, 0, 1, topts,
                               active, tpartials)
    for t, j in zip(tb, jb):
        _close(t, j, 1e-10)
    W = tpartials[("par2W", 0)][1]
    _close(W, partials[("par2W", 0)][1], 1e-10)
    jc = jupd.par2C_precompute(spec, data, state, grams, 0, 2, opts, partials)
    tc = tupd.par2C_precompute(tspec, tdata, tstate, tgrams, 0, 2, topts,
                               tpartials)
    for t, j in zip(tc, jc):
        if j is not None:
            _close(t, j, 1e-10)
    assert tupd._par2_W(tspec, tdata, tstate, 0, tpartials) is W
    fresh = tstate.replace(fac=(tstate.fac[0] + 0.0,) + tstate.fac[1:])
    assert tupd._par2_W(tspec, tdata, fresh, 0, tpartials) is not W


def test_torch_polar_and_newton_match_jax():
    """polar_orth and spd_inverse_newton (with and without lmin, and its
    rcond) at rtol 1e-10; polar_orth_ns at 1e-8 with the same iteration
    bound, converged and cut short; a zero slice stays zero; block_diag."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((4, 9, 3))
    M[2] = 0.0
    M[3, 7:] = 0.0
    tM = torch.tensor(M)
    _close(tlinalg.polar_orth(tM[[0, 1, 3]]),
           jlinalg.polar_orth(jnp.asarray(M[[0, 1, 3]])), 1e-10)
    for iters in (30, 3):
        got = tlinalg.polar_orth_ns(tM, iters=iters)
        _close(got, jlinalg.polar_orth_ns(jnp.asarray(M), iters=iters), 1e-8)
        assert not bool(got[2].any())
    G = rng.standard_normal((5, 4, 4))
    B = G @ G.transpose(0, 2, 1) + 0.5 * np.eye(4)
    lmin = rng.uniform(0.1, 0.3, 5)
    for lm in (None, lmin):
        tX, trc = tlinalg.spd_inverse_newton(
            torch.tensor(B), None if lm is None else torch.tensor(lm))
        jX, jrc = jlinalg.spd_inverse_newton(
            jnp.asarray(B), None if lm is None else jnp.asarray(lm))
        _close(tX, jX, 1e-10)
        _close(trc, jrc, 1e-10)
    _close(tlinalg.block_diag(torch.tensor(B)),
           jlinalg.block_diag(jnp.asarray(B)), 0, 0)


@pytest.mark.parametrize("method", ["chol", "inverse", "newton"])
def test_torch_batched_spd_solvers_match_jax(method):
    """make_spd_solver on a K-batch: right (X B_k = A_k, the Bk systems) and
    rowleft (B_k x_k = a_k, the par2C rows), and the ill-conditioning flag
    of a batch holding a singular matrix."""
    rng = np.random.default_rng(8)
    G = rng.standard_normal((5, 3, 3))
    B = G @ G.transpose(0, 2, 1) + np.eye(3)
    A = rng.standard_normal((5, 7, 3))
    a = rng.standard_normal((5, 3))
    opts = AlgOptions(inner_solve=method)
    topts = tp.AlgOptions(inner_solve=method)
    jr, jl, _ = jadmm.make_spd_solver(jnp.asarray(B), opts, illtol=1e-16,
                                      lmin=jnp.full((5,), 0.5))
    tr, tl, tillc = tadmm.make_spd_solver(torch.tensor(B), topts, illtol=1e-16,
                                          lmin=torch.full((5,), 0.5,
                                                          dtype=torch.float64))
    assert not bool(tillc)
    _close(tr(torch.tensor(A)), jr(jnp.asarray(A)), 1e-10)
    _close(tl(torch.tensor(a)), jl(jnp.asarray(a)), 1e-10)
    B[2] = np.diag([1.0, 1.0, 0.0])
    _, _, tillc = tadmm.make_spd_solver(torch.tensor(B), topts, illtol=1e-12)
    _, _, jillc = jadmm.make_spd_solver(jnp.asarray(B), opts, illtol=1e-12)
    assert bool(tillc) == bool(jillc)
    # the Cholesky screen flags it; Newton's rcond estimate need not
    assert bool(tillc) or method == "newton"


@pytest.mark.parametrize("K", [1, 2, 6])
def test_torch_t_smoothness_matches_jax(K):
    """The tPARAFAC2 prox (the Thomas solve's plain version, which the CPU
    takes) and penalty against the JAX package's two lax.scans at rtol
    1e-12, through make_prox as the solver builds it."""
    rng = np.random.default_rng(K)
    Bs = rng.standard_normal((K, 5, 3))
    rho = rng.uniform(0.3, 2.0, K)
    for eta in (0.5, 1000.0):
        jp, jr = jprox.make_prox(jprox.ConstraintSpec("tPARAFAC2", (eta,)), 5)
        tpx, trg = tprox.make_prox(tprox.ConstraintSpec("tPARAFAC2", (eta,)), 5)
        _close(tpx(torch.tensor(Bs), torch.tensor(rho)),
               jp(jnp.asarray(Bs), jnp.asarray(rho)), 1e-12)
        _close(trg(torch.tensor(Bs)), jr(jnp.asarray(Bs)), 1e-12)
    assert torch.equal(tprox.t_smoothness_prox(torch.tensor(Bs), torch.tensor(rho),
                                               2.0),
                       tprox.t_smoothness_reference(torch.tensor(Bs),
                                                    torch.tensor(rho), 2.0))


@pytest.mark.parametrize("kind,params", [
    ("unimodality", (True,)), ("TV regularization", (0.05,)),
    ("l2-ball", (0.8,)), ("GL smoothness", (0.7,)),
    ("non-decreasing", ()), ("l1 regularization", (0.1,)),
    ("simplex column-wise", (1.0,)), ("l2 regularization", (0.2,))])
def test_torch_prox_slicewise_matches_jax(kind, params):
    """prox_slicewise (regular slices, one batched call) and
    prox_slicewise_ragged (one call a size bucket) with one rho a slice,
    against the JAX package's vmapped proxes; padded rows exactly zero."""
    rng = np.random.default_rng(11)
    K, Jmax = 5, 9
    Bs = rng.standard_normal((K, Jmax, 4))
    rho = rng.uniform(0.5, 2.0, K)
    jp, _ = jprox.make_prox(jprox.ConstraintSpec(kind, params), Jmax)
    tpx, _ = tprox.make_prox(tprox.ConstraintSpec(kind, params), Jmax)
    _close(tadmm.prox_slicewise(tpx, torch.tensor(Bs), torch.tensor(rho)),
           jadmm.prox_slicewise(jp, jnp.asarray(Bs), jnp.asarray(rho)), 1e-12)
    if kind == "GL smoothness":
        return       # its operator has one size: never on ragged slices
    sizes = (9, 6, 9, 4, 6)
    got = tadmm.prox_slicewise_ragged(tpx, torch.tensor(Bs), torch.tensor(rho),
                                      sizes)
    want = jadmm.prox_slicewise_ragged(jp, jnp.asarray(Bs), jnp.asarray(rho),
                                       sizes)
    _close(got, want, 1e-12)
    for k, J in enumerate(sizes):
        assert not bool(got[k, J:].any())


def test_torch_parafac2_tensor_crosses_from_jax():
    """Parafac2Tensor.from_list / to_list and convert.data_from_numpy of a
    JAX-package Parafac2Tensor keep the padded slices and the mask."""
    rng = np.random.default_rng(3)
    slices = [rng.standard_normal((4, J)) for J in (3, 5, 2)]
    j = Parafac2Tensor.from_list(slices)
    t = TParafac2Tensor.from_list(slices, device="cpu")
    c = data_from_numpy((j,), device="cpu").objects[0]
    for x in (t, c):
        np.testing.assert_array_equal(x.slices.numpy(), np.asarray(j.slices))
        np.testing.assert_array_equal(x.mask.numpy(), np.asarray(j.mask))
        assert x.slices.dtype == torch.float64 and x.mask.dtype == torch.bool
    for a, b in zip(t.to_list((3, 5, 2)), slices):
        np.testing.assert_array_equal(a.numpy(), b)


def test_torch_parafac2_tensor_from_list_defaults_to_the_card():
    """The port's entry points put data on the card unless asked for the
    CPU, as the JAX package's from_list puts it on the default device."""
    import inspect
    sig = inspect.signature(TParafac2Tensor.from_list)
    assert sig.parameters["device"].default == "cuda"


def test_torch_t_smooth_plan_and_cpu_dispatch():
    """Kernel C's plan: the staged route (two mbarriers a chunk of 32
    recurrence steps, {rho, m, d', y} and a tile of T_TILE elements a
    slice: 16 ceil(K / 32) + (4 + T_TILE) K itemsize bytes a block) while
    it fits and its grid runs in one wave on the card's SMs (by their 228
    KB of shared memory), the stream route (d' and m a slice, 2 K values)
    after, ValueError past a block's limit; the wrappers refuse
    CPU tensors (a CPU tensor takes the plain version in
    ops/prox.t_smoothness_prox)."""
    from matlab_code_tpu_torch.ops import prox_cuda
    S, T = prox_cuda.STAGED, prox_cuda.STREAM
    assert prox_cuda.T_TILE == 32 and prox_cuda.T_CHUNK == 32
    assert prox_cuda.plan_t_smooth(512, 8192, torch.float32) == \
        (S, 16 * 16 + 36 * 512 * 4)
    # float64 at the PAR2 shape: 256 blocks of 148 KB, one an SM, would
    # take two waves on 132 SMs; 132 blocks take one
    assert prox_cuda.plan_t_smooth(512, 8192, torch.float64) == \
        (T, 2 * 512 * 8)
    assert prox_cuda.plan_t_smooth(512, 132 * 32, torch.float64) == \
        (S, 16 * 16 + 36 * 512 * 8)
    assert prox_cuda.plan_t_smooth(512, 132 * 32 + 1, torch.float64)[0] == T
    assert prox_cuda.plan_t_smooth(512, 8192, torch.float64, sms=256)[0] == S
    # float32: three 74 KB blocks an SM, 396 blocks a wave
    assert prox_cuda.plan_t_smooth(512, 396 * 32, torch.float32)[0] == S
    assert prox_cuda.plan_t_smooth(512, 396 * 32 + 1, torch.float32)[0] == T
    assert prox_cuda.plan_t_smooth(1601, 7, torch.float32)[0] == S
    assert prox_cuda.plan_t_smooth(1602, 7, torch.float32)[0] == T
    assert prox_cuda.plan_t_smooth(802, 7, torch.float64)[0] == S
    assert prox_cuda.plan_t_smooth(803, 7, torch.float64) == \
        (T, 2 * 803 * 8)
    assert prox_cuda.plan_t_smooth(14464, 1, torch.float64)[1] <= prox_cuda.SMEM_LIMIT
    assert prox_cuda.plan_t_smooth(28928, 1, torch.float32)[1] <= prox_cuda.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        prox_cuda.plan_t_smooth(14465, 1, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        prox_cuda.plan_t_smooth(28929, 1, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        prox_cuda.t_smooth_cols(torch.zeros((2, 3, 4)), torch.ones(2), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        prox_cuda.prox_tv_cols(torch.zeros((2, 3, 4)), torch.ones(2))
