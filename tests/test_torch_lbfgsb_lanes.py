"""The lanes form of the port's L-BFGS-B (ops/lbfgsb.py, fit_multistart's
start axis) against its host-loop form, one call a start, and the batching
rules of kernel D's pass and of the sparse MTTKRP against one plain call a
start, on the CPU in float64.

The problems are KL factor subproblems of a 15 x 10 x 12 count tensor,
each start with its own factors: the lanes give each start the x, f and
iterations of its own host-loop call, with rings that hold different
counts k (and wrap at m = 2), under an evaluation budget, and with starts
left out by `active`; the reads are one at the start and one a
line-search try for all starts, so S identical starts read as one.
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.models.admm import to_host
from matlab_code_tpu_torch.ops import losses, sparse_cuda
from matlab_code_tpu_torch.ops.lbfgsb import lbfgsb
from matlab_code_tpu_torch.ops.tensor import (
    ktensor_full, mttkrp, mttkrp_sparse)

SHAPE, R, EPS_LOG = (15, 10, 12), 2, 1e-10


def _problem(S, seed=0):
    g = torch.Generator().manual_seed(seed)
    true = [torch.rand((n, R), generator=g, dtype=torch.float64) + 0.1
            for n in SHAPE]
    X = torch.poisson(20.0 * ktensor_full(true), generator=g)
    facs = [torch.rand((S, n, R), generator=g, dtype=torch.float64) + 0.05
            for n in SHAPE]
    return X, facs


def _solve(X, mode, **kw):
    """run(f0, f1, f2): L-BFGS-B on one mode's factor, the others fixed."""
    def run(*facs, active=None):
        shape = facs[mode].shape

        def vag(xvec):
            x = xvec.reshape(shape)
            fs = [f if j != mode else x for j, f in enumerate(facs)]
            f, Y = losses.loss_fg("KL", X, ktensor_full(fs), EPS_LOG)
            return f, mttkrp(Y, fs, mode).reshape(-1)
        res = lbfgsb(vag, facs[mode].reshape(-1), 0.0, float("inf"),
                     active=active, **kw)
        return res.x, res.f, torch.as_tensor(res.iterations)
    return run


def _per_start(run, facs):
    """The host-loop form, one call a start: (x, f, iterations, reads)."""
    out = []
    for s in range(facs[0].shape[0]):
        calls = to_host.calls
        x, f, it = run(*(f[s] for f in facs))
        out.append((x, f, int(it), to_host.calls - calls))
    return out


@pytest.mark.parametrize("mode,kw", [
    (0, dict(m=5, maxiter=300, pgtol=1e-9, factr=1e3)),
    (1, dict(m=2, maxiter=300, pgtol=1e-9, factr=1e3)),
    (2, dict(m=5, maxiter=300, pgtol=1e-9, factr=1e3, max_total_its=36)),
])
def test_torch_lbfgsb_lanes_match_the_host_loop_per_start(mode, kw):
    """4 starts on one start axis against the host-loop form of each: x to
    rtol 1e-12, f to 1e-13, each start's iterations (the rings' counts k
    differ between the starts; m = 2 wraps; the budget ends some starts).
    The reads lie between the most any one start's call makes and their
    sum."""
    X, facs = _problem(4, seed=mode)
    run = _solve(X, mode, **kw)
    calls = to_host.calls
    xs, fs, its = torch.func.vmap(run)(*facs)
    reads = to_host.calls - calls
    want = _per_start(run, facs)
    assert len({w[2] for w in want}) > 1       # the starts stop apart
    for s, (x, f, it, _) in enumerate(want):
        assert int(its[s]) == it
        np.testing.assert_allclose(xs[s].numpy(), x.numpy(), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(float(fs[s]), float(f), rtol=1e-13)
    assert max(w[3] for w in want) <= reads <= sum(w[3] for w in want)


def test_torch_lbfgsb_lanes_identical_starts_read_as_one():
    """S identical starts make exactly the reads of one start's call and
    each gives its result."""
    X, facs = _problem(1, seed=5)
    run = _solve(X, 0, m=5, maxiter=100, pgtol=1e-8)
    (x, f, it, reads), = _per_start(run, facs)
    calls = to_host.calls
    xs, _, its = torch.func.vmap(run)(*(f.expand(3, -1, -1) for f in facs))
    assert to_host.calls - calls == reads
    assert its.tolist() == [it] * 3
    for s in range(3):
        np.testing.assert_allclose(xs[s].numpy(), x.numpy(), rtol=1e-12,
                                   atol=1e-15)


def test_torch_lbfgsb_lanes_inactive_starts_take_no_iteration():
    """Starts outside `active` take no iteration and keep x0 (projected);
    the others are their own host-loop calls."""
    X, facs = _problem(3, seed=7)
    run = _solve(X, 1, m=5, maxiter=100, pgtol=1e-8)
    active = torch.tensor([True, False, True])
    xs, _, its = torch.func.vmap(lambda a, b, c, act: run(a, b, c,
                                                          active=act))(
        *facs, active)
    want = _per_start(run, facs)
    assert int(its[1]) == 0
    assert torch.equal(xs[1], facs[1][1].reshape(-1).clamp(min=0.0))
    for s in (0, 2):
        assert int(its[s]) == want[s][2] > 0
        np.testing.assert_allclose(xs[s].numpy(), want[s][0].numpy(),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("loss,beta", [("KL", None), ("beta", 0.5)])
def test_torch_loss_fg_batching_rule_matches_plain_calls(loss, beta):
    """The loss pass on the start axis (ops/losses._loss_fg_starts: the
    plain version over the start axis on the CPU), X shared and X one a
    start, against loss_fg_reference a start: Y bit for bit, f to 1e-14."""
    g = torch.Generator().manual_seed(11)
    S = 3
    M = torch.rand((S, 6, 7, 8), generator=g, dtype=torch.float64) + 0.1
    Xs = torch.poisson(3.0 * M, generator=g)
    for X, dims in ((Xs[0], (None, 0)), (Xs, (0, 0))):
        f, Y = torch.func.vmap(lambda x, mm: losses.loss_fg(
            loss, x, mm, EPS_LOG, beta), in_dims=dims)(X, M)
        for s in range(S):
            fr, Yr = losses.loss_fg_reference(
                loss, X if dims[0] is None else X[s], M[s], EPS_LOG, beta)
            assert torch.equal(Y[s], Yr)
            np.testing.assert_allclose(float(f[s]), float(fr), rtol=1e-14)


def test_torch_sparse_batching_rule_matches_plain_calls(monkeypatch):
    """The sparse MTTKRP on the start axis (ops/tensor.
    _mttkrp_sparse_starts: the starts' factors side by side, one call)
    against mttkrp_sparse_reference a start, without a plan and through a
    CPU plan, and with the starts split into groups where the partial
    sums would pass PARTIAL_BYTES_MAX (sparse_cuda.start_groups)."""
    g = torch.Generator().manual_seed(13)
    shape, S, Rk, nnz = (8, 9, 10), 5, 3, 120
    idx = torch.stack([torch.randint(0, n, (nnz,), generator=g)
                       for n in shape], 1).to(torch.int32)
    vals = torch.rand(nnz, generator=g, dtype=torch.float64)
    F = [torch.rand((S, n, Rk), generator=g, dtype=torch.float64)
         for n in shape]
    for mode in range(3):
        want = torch.stack([sparse_cuda.mttkrp_sparse_reference(
            idx, vals, [f[s] for f in F], mode, shape[mode])
            for s in range(S)])
        plan = sparse_cuda.build_plan(idx, vals, shape, mode, Rk)
        for p in (None, plan):
            got = torch.func.vmap(lambda a, b, c: mttkrp_sparse(
                idx, vals, [a, b, c], mode, shape[mode], p))(*F)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-13, atol=1e-15)
        per_start = plan.nchunks * Rk * 8
        monkeypatch.setattr(sparse_cuda, "PARTIAL_BYTES_MAX", 2 * per_start)
        assert sparse_cuda.start_groups(plan, S, Rk) == [
            slice(0, 2), slice(2, 4), slice(4, 5)]
        got = torch.func.vmap(lambda a, b, c: mttkrp_sparse(
            idx, vals, [a, b, c], mode, shape[mode], plan))(*F)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                                   atol=1e-15)
        monkeypatch.undo()
    assert sparse_cuda.start_groups(None, S, Rk) == [slice(0, S)]
