"""The fused evaluation of kernel D (csrc/loss_fg.cu, ops/loss_cuda.
loss_fg_mttkrp_cuda: sum fh and the gh MTTKRP of a dense 3-way X, the CP
model formed in the kernel) on a CUDA card against its plain version
(ops/losses.loss_fg_mttkrp_reference: ktensor_full, loss_fg_reference and
torch.einsum) on the same card.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_loss_fused_cuda.py
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.ops import losses
from matlab_code_tpu_torch.ops.loss_cuda import (
    loss_fg_cuda, loss_fg_mttkrp_cuda, loss_fg_mttkrp_cuda_starts)
from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
from matlab_code_tpu_torch.ops.tensor import ktensor_full, mttkrp_einsum

pytestmark = pytest.mark.cuda

EPS_LOG = 1e-10
CASES = [("KL", None), ("IS", None), ("beta", 0.5), ("beta", 1.5)]
# G: each entry sums gh times two factor entries over J K (or I K, I J)
# elements in another order than torch.einsum, and gh is a difference of
# two rounded terms of a model summed in another order: held to rtol times
# the MTTKRP of |gh's terms| and |factors|.  f: rtol of |sum fh| (summed in
# float64 in another order than torch.sum, of fh of that model)
RTOL = {torch.float32: (1e-5, 1e-5), torch.float64: (1e-12, 1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel D has no CPU mode")
    return torch.device("cuda")


def gh_scale(loss, X, M, eps_log, beta):
    """|first term| + |second term| of gh, elementwise."""
    if loss == "KL":
        return 1.0 + (X / (M + eps_log)).abs()
    if loss == "IS":
        return (X / (M + eps_log) ** 2).abs() + (1.0 / (M + eps_log)).abs()
    return (M ** (beta - 1.0)).abs() + (X * M ** (beta - 2.0)).abs()


def problem(shape, R, dtype, dev, seed=7, starts=None):
    """Factors U(0.1, 1.1) and Poisson counts of their model."""
    rng = np.random.default_rng(seed)
    lead = () if starts is None else (starts,)
    facs = [rng.uniform(0.1, 1.1, size=lead + (n, R)) for n in shape]
    M = np.einsum("...ir,...jr,...kr->...ijk", *facs)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    return [t(F) for F in facs], t(rng.poisson(M).astype(np.float64))


def check_fused(loss, beta, X, facs, mode, grad=True):
    """The kernel against its plain version; returns (f err, G err)."""
    rtol_g, rtol_f = RTOL[X.dtype]
    before = loss_fg_mttkrp_cuda.launches
    f, G = loss_fg_mttkrp_cuda(loss, X, facs, mode, EPS_LOG, beta, grad)
    torch.cuda.synchronize()
    assert loss_fg_mttkrp_cuda.launches == before + 1
    f_ref, G_ref = losses.loss_fg_mttkrp_reference(loss, X, facs, mode,
                                                   EPS_LOG, beta, grad)
    assert f.shape == () and f.dtype == X.dtype
    err_f = abs(float(f) - float(f_ref)) / abs(float(f_ref))
    assert err_f <= rtol_f, (loss, beta, mode, X.dtype, err_f)
    if not grad:
        assert G is None
        return err_f, 0.0
    M = ktensor_full(facs)
    scale = mttkrp_einsum(gh_scale(loss, X, M, EPS_LOG, beta),
                          [F.abs() for F in facs], mode)
    assert G.shape == G_ref.shape and G.dtype == X.dtype
    err_g = float(((G - G_ref).abs() / scale).max())
    assert err_g <= rtol_g, (loss, beta, mode, X.dtype, err_g)
    return err_f, err_g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_loss_fused_matches_plain(cuda_device, dtype):
    """Every loss, modes 0-2 and the f-only pass, at the KL workload's
    128 x 256 x 256 (R 8) and at odd shapes (R 3, 8 and 40)."""
    for shape, ranks in (((128, 256, 256), (8,)), ((37, 50, 29), (3, 8, 40)),
                         ((1, 1, 1), (3, 40)), ((5, 3, 130), (8,)),
                         ((2, 700, 4), (3,))):
        for R in ranks:
            facs, X = problem(shape, R, dtype, cuda_device)
            for loss, beta in CASES:
                for mode in range(3):
                    check_fused(loss, beta, X, facs, mode)
                check_fused(loss, beta, X, facs, 0, grad=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_loss_fused_bits(cuda_device, dtype):
    """The same bits on repeat, and on the start axis each start's f and G
    the bits of its own single launch (X shared, and one X a start), one
    launch for all starts."""
    S, shape, R = 5, (37, 50, 29), 8
    facs, X = problem(shape, R, dtype, cuda_device, starts=S)
    for mode in range(3):
        f1, G1 = loss_fg_mttkrp_cuda("KL", X[0], [F[0] for F in facs], mode,
                                     EPS_LOG)
        f2, G2 = loss_fg_mttkrp_cuda("KL", X[0], [F[0] for F in facs], mode,
                                     EPS_LOG)
        assert torch.equal(f1, f2) and torch.equal(G1, G2)
        for Xs in (X[0], X):
            before = loss_fg_mttkrp_cuda.launches
            f, G = loss_fg_mttkrp_cuda_starts("beta", Xs, facs, mode, EPS_LOG,
                                              1.5)
            assert loss_fg_mttkrp_cuda.launches == before + 1
            for s in range(S):
                fs, Gs = loss_fg_mttkrp_cuda(
                    "beta", Xs if Xs.dim() == 3 else Xs[s],
                    [F[s] for F in facs], mode, EPS_LOG, 1.5)
                assert torch.equal(fs, f[s]) and torch.equal(Gs, G[s])


def test_torch_loss_fused_raises(cuda_device):
    facs, X = problem((6, 7, 8), 3, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        loss_fg_mttkrp_cuda("KL", X.transpose(0, 2).contiguous().transpose(
            0, 2), facs, 0, EPS_LOG)
    with pytest.raises(ValueError, match="contiguous"):
        loss_fg_mttkrp_cuda("KL", X, [facs[0].T.contiguous().T] + facs[1:], 0,
                            EPS_LOG)
    with pytest.raises(ValueError, match="float32 or float64"):
        loss_fg_mttkrp_cuda("KL", X.half(), [F.half() for F in facs], 0,
                            EPS_LOG)
    with pytest.raises(ValueError, match="differ"):
        loss_fg_mttkrp_cuda("KL", X, [F.double() for F in facs], 0, EPS_LOG)
    with pytest.raises(ValueError, match="rows"):
        loss_fg_mttkrp_cuda("KL", X[:5].contiguous(), facs, 0, EPS_LOG)
    with pytest.raises(ValueError, match="rank 65"):
        big = [torch.ones((n, 65), device=cuda_device) for n in X.shape]
        loss_fg_mttkrp_cuda("KL", X, big, 0, EPS_LOG)


def test_torch_loss_fused_fit_route(cuda_device):
    """A KL fit of a 3-way dataset on the card takes the fused kernel for
    every evaluation: no old pass, no mttkrp3.  At rank 65, past the fused
    route's 16 in float32 (and the kernel's 64), it keeps the old pass and
    mttkrp3 and runs to its end."""
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm
    from matlab_code_tpu_torch.utils import kl_workload as klw
    for rank, fused in ((3, True), (65, False)):
        spec, data, state0, _ = klw.build_problem(
            cuda_device, torch.float32, shape=(16, 32, 24), rank=rank)
        loss_fg_mttkrp_cuda.launches = loss_fg_cuda.launches = 0
        mttkrp3.launches = 0
        opts = klw.kl_options(3, AbsFuncTol=0.0, OuterRelTol=0.0)
        _, _, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
        assert out.OuterIterations == 3
        assert np.all(np.isfinite(out.func_val_conv))
        if fused:
            assert loss_fg_mttkrp_cuda.launches > 0
            assert loss_fg_cuda.launches == 0 and mttkrp3.launches == 0
        else:
            assert loss_fg_mttkrp_cuda.launches == 0
            assert loss_fg_cuda.launches > 0 and mttkrp3.launches > 0
