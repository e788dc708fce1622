"""fit_multistart's other losses and sparse COO data on a CUDA card: kernel
D on the start axis (one launch for S starts, each start's f and Y the
bits of its own launch), the sparse kernel's call of S R columns against
S single-start calls, and the lanes L-BFGS-B and the sparse path on the
card against the CPU in float64.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_multistart_rest_cuda.py
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.models.multistart import _fit_lanes
from matlab_code_tpu_torch.ops import losses
from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_cuda, loss_fg_cuda_starts
from matlab_code_tpu_torch.ops.sparse_cuda import build_plan, mttkrp_sparse_cuda
from matlab_code_tpu_torch.ops.tensor import mttkrp_sparse
from matlab_code_tpu_torch.utils import multistart_workload as mw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("loss,beta,shared", [("KL", None, True),
                                              ("IS", None, False),
                                              ("beta", 1.5, True)])
def test_torch_loss_fg_starts_is_each_start_bit_for_bit(cuda_device, dtype,
                                                        loss, beta, shared):
    """One launch for 5 starts at an odd length, X shared or one a start,
    under the vmap of the start axis too: each start's f and Y the bits of
    its own loss_fg_cuda call."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    S, n = 5, 100003
    M = (0.05 + 2.95 * torch.rand((S, n), generator=g, device=cuda_device,
                                  dtype=torch.float64)).to(dtype)
    X = torch.poisson(M.double() if shared is False else M[0].double(),
                      generator=g).to(dtype)
    before = loss_fg_cuda.launches
    f, Y = loss_fg_cuda_starts(loss, X, M, 1e-10, beta)
    assert loss_fg_cuda.launches - before == 1
    fv, Yv = torch.func.vmap(lambda m, x: losses.loss_fg(loss, x, m, 1e-10,
                                                          beta),
                             in_dims=(0, None if shared else 0))(M, X)
    for s in range(S):
        f1, Y1 = loss_fg_cuda(loss, X if shared else X[s], M[s], 1e-10, beta)
        assert torch.equal(f1, f[s]) and torch.equal(Y1, Y[s])
        assert torch.equal(f1, fv[s]) and torch.equal(Y1, Yv[s])


@pytest.mark.parametrize("variant", ["fiber", "chunk"])
def test_torch_sparse_starts_call_on_card(cuda_device, variant):
    """The starts' sparse MTTKRPs as one call of S R columns through the
    plan built at rank R, against one call a start: float64 within 1e-12,
    in one launch a mode."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    shape, R, S, nnz = (37, 50, 29), 5, 7, 4000
    idx = torch.stack([torch.randint(0, d, (nnz,), generator=g,
                                     device=cuda_device) for d in shape],
                      1).to(torch.int32)
    vals = torch.rand(nnz, generator=g, device=cuda_device,
                      dtype=torch.float64)
    F = [torch.rand((S, d, R), generator=g, device=cuda_device,
                    dtype=torch.float64) for d in shape]
    for mode in range(3):
        plan = build_plan(idx, vals, shape, mode, R, variant=variant)
        before = mttkrp_sparse_cuda.launches
        got = torch.func.vmap(lambda a, b, c: mttkrp_sparse(
            idx, vals, [a, b, c], mode, shape[mode], plan))(*F)
        assert mttkrp_sparse_cuda.launches - before == 1
        want = torch.stack([mttkrp_sparse_cuda(plan, [f[s] for f in F])
                            for s in range(S)])
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("case", ["kl", "sparse"])
def test_torch_multistart_rest_on_card_matches_cpu(cuda_device, case):
    """Three starts in float64 on the card against the CPU: the KL workload
    cut to 24 x 32 x 40 rank 3 (the lanes L-BFGS-B, kernel D on the start
    axis), and the sparse workload cut to 64^3 with 20,000 draws."""
    def build(dev):
        if case == "kl":
            return mw.kl_problem(dev, torch.float64, shape=(24, 32, 40),
                                 rank=3)
        return mw.sparse_problem(dev, torch.float64, D=64, NNZ=20000, R=4)
    spec, data_c, opts, init = build("cpu")
    _, data_g, _, _ = build(cuda_device)
    opts = dataclasses.replace(opts, MaxOuterIters=3, AbsFuncTol=0.0,
                               OuterRelTol=0.0)
    init_np = [state_to_numpy(init_coupled(spec, data_c, init, seed=k))
               for k in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu = _fit_lanes(spec, data_c, [state_from_numpy(s, "cpu")
                                        for s in init_np], opts)
        gpu = _fit_lanes(spec, data_g, [state_from_numpy(s, cuda_device)
                                        for s in init_np], opts)
    for a, b in zip(gpu.outs, cpu.outs):
        assert a.OuterIterations == b.OuterIterations
        np.testing.assert_array_equal(a.innerIters, b.innerIters)
        if case == "kl":
            np.testing.assert_array_equal(a.lbfgsb_iterations,
                                          b.lbfgsb_iterations)
        for k in ("func_val_conv", "func_constr_conv"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       rtol=1e-8, atol=1e-14, err_msg=k)
