"""Kernel D (csrc/loss_fg.cu, ops/loss_cuda.loss_fg_cuda) on a CUDA card
against its plain version (ops/losses.loss_fg_reference) on the same card.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_loss_cuda.py
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.ops import losses
from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_cuda

pytestmark = pytest.mark.cuda

CASES = [("KL", None), ("IS", None), ("beta", 0.5), ("beta", 1.5),
         ("beta", 2.0), ("beta", 1.25)]
# Y: each element of gh is a difference of two terms, so it is held to
# rtol times the sum of the terms' magnitudes; f: rtol of |sum fh| (the
# kernel sums in float64 in another order than torch.sum)
RTOL = {torch.float32: (1e-6, 1e-5), torch.float64: (1e-12, 1e-12)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel D has no CPU mode")
    return torch.device("cuda")


def gh_scale(loss, X, M, eps_log, beta):
    """|first term| + |second term| of gh, elementwise."""
    if loss == "KL":
        return 1.0 + (X / (M + eps_log)).abs()
    if loss == "IS":
        return (X / (M + eps_log) ** 2).abs() + (1.0 / (M + eps_log)).abs()
    return (M ** (beta - 1.0)).abs() + (X * M ** (beta - 2.0)).abs()


def check_loss_kernel(loss, beta, X, M, eps_log=1e-10):
    """Kernel D against the plain version on the same card tensors; returns
    (max |f - f_plain| / |f_plain|, max |Y - Y_plain| / scale)."""
    rtol_y, rtol_f = RTOL[X.dtype]
    before = loss_fg_cuda.launches
    f, Y = loss_fg_cuda(loss, X, M, eps_log, beta)
    torch.cuda.synchronize()
    assert loss_fg_cuda.launches == before + 1
    f_ref, Y_ref = losses.loss_fg_reference(loss, X, M, eps_log, beta)
    assert f.dtype == X.dtype and Y.dtype == X.dtype and Y.shape == X.shape
    scale = gh_scale(loss, X, M, eps_log, beta)
    err_y = float(((Y - Y_ref).abs() / scale).max())
    err_f = abs(float(f) - float(f_ref)) / abs(float(f_ref))
    assert err_y <= rtol_y, (loss, beta, X.dtype, err_y)
    assert err_f <= rtol_f, (loss, beta, X.dtype, err_f)
    f2, Y2 = loss_fg_cuda(loss, X, M, eps_log, beta)
    assert torch.equal(f2, f) and torch.equal(Y2, Y)   # deterministic
    return err_f, err_y


@pytest.mark.parametrize("loss,beta", CASES)
@pytest.mark.parametrize("shape", [(37, 50, 29), (1,), (255,), (257, 3),
                                   (128, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_loss_kernel_matches_plain(cuda_device, loss, beta, shape, dtype):
    rng = np.random.default_rng(7)
    M = rng.uniform(0.05, 3.0, size=shape)
    X = rng.poisson(M).astype(np.float64)
    check_loss_kernel(loss, beta, torch.tensor(X, dtype=dtype, device=cuda_device),
                      torch.tensor(M, dtype=dtype, device=cuda_device))


def test_torch_loss_kernel_raises_on_non_contiguous(cuda_device):
    X = torch.ones((8, 6), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        loss_fg_cuda("KL", X.T, X.T, 1e-10)
    with pytest.raises(ValueError, match="float32 or float64"):
        loss_fg_cuda("KL", X.half(), X.half(), 1e-10)
