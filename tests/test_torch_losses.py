"""The port's loss functions (matlab_code_tpu_torch/ops/losses.py) against
the JAX package's (matlab_code_tpu/ops/losses.py) in float64 on the CPU:
fh, gh, Znorm_const and the box bounds of KL, IS and beta, and the plain
version of kernel D, loss_fg_reference, which loss_fg takes for CPU
tensors.  Kernel D itself runs only on the card
(tests/test_torch_loss_cuda.py); here its wrapper's checks and grid."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matlab_code_tpu.ops import losses as jlosses
from matlab_code_tpu_torch.ops import loss_cuda, losses as tlosses

CASES = [("KL", None), ("IS", None), ("beta", 0.5), ("beta", 1.5),
         ("beta", 2.0), ("beta", 3.0)]
EPS_LOG = 1e-10


def _data(seed=3, shape=(7, 5, 6)):
    """Poisson counts (zeros among them) and a positive model."""
    rng = np.random.default_rng(seed)
    M = rng.uniform(0.05, 3.0, size=shape)
    X = rng.poisson(M).astype(np.float64)
    return X, M


def _close(got, want, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("loss,beta", CASES)
def test_torch_loss_terms_match_jax(loss, beta):
    X, M = _data()
    tX, tM = torch.tensor(X), torch.tensor(M)
    jX, jM = jnp.asarray(X), jnp.asarray(M)
    _close(tlosses.loss_fh(loss, tX, tM, EPS_LOG, beta),
           jlosses.loss_fh(loss, jX, jM, EPS_LOG, beta))
    _close(tlosses.loss_gh(loss, tX, tM, EPS_LOG, beta),
           jlosses.loss_gh(loss, jX, jM, EPS_LOG, beta))
    # IS needs positive data for a finite constant
    Xz = X + 0.5 if loss == "IS" else X
    _close(tlosses.znorm_const(loss, torch.tensor(Xz), EPS_LOG, beta),
           jlosses.znorm_const(loss, jnp.asarray(Xz), EPS_LOG, beta))
    assert tlosses.loss_bounds(loss) == tuple(
        float(b) for b in jlosses.loss_bounds(loss))


@pytest.mark.parametrize("loss,beta", CASES)
def test_torch_loss_fg_reference_matches_jax(loss, beta):
    """(sum fh, gh) of the plain version against the JAX package's
    sum(loss_fh) and loss_gh; loss_fg takes it for CPU tensors."""
    X, M = _data(seed=5, shape=(13, 11))
    f, Y = tlosses.loss_fg_reference(loss, torch.tensor(X), torch.tensor(M),
                                     EPS_LOG, beta)
    assert f.shape == () and Y.shape == X.shape and Y.dtype == torch.float64
    _close(f, jnp.sum(jlosses.loss_fh(loss, jnp.asarray(X), jnp.asarray(M),
                                      EPS_LOG, beta)))
    _close(Y, jlosses.loss_gh(loss, jnp.asarray(X), jnp.asarray(M), EPS_LOG,
                              beta))
    before = loss_cuda.loss_fg_cuda.launches
    f2, Y2 = tlosses.loss_fg(loss, torch.tensor(X), torch.tensor(M), EPS_LOG,
                             beta)
    assert loss_cuda.loss_fg_cuda.launches == before
    assert torch.equal(f2, f) and torch.equal(Y2, Y)


def test_torch_frobenius_constant_and_bounds():
    X, _ = _data()
    mask = X > 1
    _close(tlosses.znorm_const("Frobenius", torch.tensor(X), EPS_LOG),
           jlosses.znorm_const("Frobenius", jnp.asarray(X), EPS_LOG))
    _close(tlosses.znorm_const("Frobenius", torch.tensor(X), EPS_LOG,
                               mask=torch.tensor(mask)),
           jlosses.znorm_const("Frobenius", jnp.asarray(X), EPS_LOG,
                               mask=jnp.asarray(mask)))
    assert tlosses.loss_bounds("Frobenius") == (-math.inf, math.inf)
    with pytest.raises(ValueError):
        tlosses.loss_fh("Frobenius", torch.ones(2), torch.ones(2), EPS_LOG)
    with pytest.raises(ValueError):
        tlosses.znorm_const("no such loss", torch.ones(2), EPS_LOG)


def test_torch_loss_kernel_refuses_what_it_does_not_take():
    """The wrapper's checks, made before any build or launch: a CPU
    tensor, an unknown loss, beta without its parameter."""
    X = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="not a CUDA card"):
        loss_cuda.loss_fg_cuda("KL", X, X, EPS_LOG)
    with pytest.raises(ValueError, match="no kernel"):
        loss_cuda.loss_fg_cuda("Frobenius", X, X, EPS_LOG)
    with pytest.raises(ValueError, match="beta"):
        loss_cuda.loss_fg_cuda("beta", X, X, EPS_LOG)
    assert loss_cuda._LIB is None


@pytest.mark.parametrize("n,sms,want", [
    (1, 132, 1), (256, 132, 1), (257, 132, 2), (270_000, 132, 1055),
    (8_388_608, 132, 1056), (8_388_608, 114, 912)])
def test_torch_loss_kernel_grid(n, sms, want):
    """One block a 256 elements, at most 8 blocks an SM: at the KL
    workload's 8.39 M elements 1,056 partials on an H100's 132 SMs."""
    assert loss_cuda.grid_blocks(n, sms) == want
