"""The sequential-prox kernels (csrc/prox_seq.cu: kernel A, isotonic and
unimodal; kernel B, TV) on a CUDA card, and coupled fits of types 1 and 5
on the card against the CPU.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_prox_cuda.py
"""
import numpy as np
import pytest
import torch

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.ops import isotonic, prox, prox_cuda, tv
from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
from matlab_code_tpu_torch.utils import surface

pytestmark = pytest.mark.cuda

NS = (1, 2, 29, 256, 512, 1024, 4096)
RS = (1, 16, 20, 40)
KINDS_A = ((isotonic.INCREASING, False), (isotonic.DECREASING, False),
           (isotonic.UNIMODAL, False), (isotonic.UNIMODAL, True))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, R, seed=2):
    """Normal columns, a constant column, ties (a 0.5 grid) and an
    all-negative column."""
    rng = np.random.default_rng(seed + 13 * n + R)
    X = rng.standard_normal((n, R))
    if R >= 4:
        X[:, 1] = -0.7
        X[:, 2] = np.round(2 * X[:, 2]) / 2
        X[:, 3] = -np.abs(X[:, 3]) - 0.1
    return X


def _assert_close(got, want, rtol):
    """Elementwise |got - want| <= rtol |want|, against the float64 plain
    version of the same (rounded) input: the kernels walk the same
    arithmetic in float64, so float64 agrees to rounding and float32 is
    that result rounded once."""
    g, w = got.double().cpu(), want.double()
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=0)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("n", NS)
def test_torch_isotonic_kernel_matches_plain(cuda_device, n, R):
    X = _inputs(n, R)
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        for kind, nn in KINDS_A:
            want = isotonic.columns_reference(Xd.double().cpu(), kind, nn)
            before = prox_cuda.project_isotonic_cols.launches
            got = prox_cuda.project_isotonic_cols(Xd, kind, nn)
            torch.cuda.synchronize()
            assert prox_cuda.project_isotonic_cols.launches == before + 1
            assert got.dtype == dt and got.shape == (n, R)
            _assert_close(got, want, rtol)
            assert torch.equal(prox_cuda.project_isotonic_cols(Xd, kind, nn), got)
            if nn:
                assert float(got.min()) >= 0


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("n", NS)
def test_torch_tv_kernel_matches_plain(cuda_device, n, R):
    """lam = 0 (the column itself), a small lam, and lam above every
    column's total variation (the column means), as a number and as a 0-d
    card tensor."""
    X = _inputs(n, R)
    tv_max = float(np.abs(np.diff(X, axis=0)).sum(axis=0).max()) if n > 1 else 0
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        for lam in (0.0, 0.05, tv_max + 1.0):
            want = tv.columns_reference(Xd.double().cpu(), lam)
            before = prox_cuda.prox_tv_cols.launches
            got = prox_cuda.prox_tv_cols(Xd, lam)
            got_t = prox_cuda.prox_tv_cols(
                Xd, torch.tensor(lam, dtype=torch.float64, device=cuda_device))
            torch.cuda.synchronize()
            assert prox_cuda.prox_tv_cols.launches == before + 2
            assert got.dtype == dt and torch.equal(got, got_t)
            _assert_close(got, want, rtol)


def test_torch_sequential_proxes_dispatch_to_the_kernels(cuda_device):
    """make_prox's monotone, unimodal and TV proxes launch the kernels on a
    card tensor (a view that is not contiguous too), with rho a card
    tensor; a dtype the kernels do not take raises."""
    X = torch.tensor(_inputs(30, 6), device=cuda_device)
    rho = torch.tensor(0.5, dtype=torch.float64, device=cuda_device)
    for kind, params, n_a, n_b in (("non-decreasing", (), 1, 0),
                                   ("non-increasing", (), 1, 0),
                                   ("unimodality", (1,), 1, 0),
                                   ("TV regularization", (0.1,), 0, 1)):
        p, _ = prox.make_prox(prox.ConstraintSpec(kind, params), 30)
        a, b = (prox_cuda.project_isotonic_cols.launches,
                prox_cuda.prox_tv_cols.launches)
        got = p(X.T.contiguous().T, rho)
        assert (prox_cuda.project_isotonic_cols.launches - a,
                prox_cuda.prox_tv_cols.launches - b) == (n_a, n_b)
        _assert_close(got, p(X.cpu(), 0.5), 1e-12)
    with pytest.raises(ValueError, match="float32 or float64"):
        prox_cuda.prox_tv_cols(X.half(), 0.1)


@pytest.mark.parametrize("ctype", [1, 5])
def test_torch_coupled_fit_on_cuda_matches_cpu(cuda_device, ctype):
    """The surface workload (mode sizes / 4) of coupling type 1 or 5 on the
    card and on the CPU in float64 from one init state, 3 outer
    iterations: the four streams at rtol 1e-8, with the dense MTTKRP and
    both sequential-prox kernels launched."""
    spec, data_c, ds = surface.build_problem(ctype, "cpu", torch.float64,
                                             scale=4)
    state0 = state_to_numpy(init_coupled(
        spec, data_c, surface.surface_init_options(ctype), seed=1,
        delta_shapes=ds))
    opts = surface.surface_options(3, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_cpu = tp.fit(spec, data_c, state_from_numpy(state0, "cpu"), opts)
    _, data_d, _ = surface.build_problem(ctype, cuda_device, torch.float64,
                                         scale=4)
    before = (mttkrp3.launches,
              prox_cuda.project_isotonic_cols.launches,
              prox_cuda.prox_tv_cols.launches)
    _, out = tp.fit(spec, data_d, state_from_numpy(state0, cuda_device), opts)
    after = (mttkrp3.launches,
             prox_cuda.project_isotonic_cols.launches,
             prox_cuda.prox_tv_cols.launches)
    assert [a - b for a, b in zip(after, before)][0] >= 6 * 3
    assert all(a > b for a, b in zip(after, before))
    for a, b in [(out.func_val_conv, out_cpu.func_val_conv),
                 (out.func_coupl_conv, out_cpu.func_coupl_conv),
                 (out.func_constr_conv, out_cpu.func_constr_conv)]:
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0)
