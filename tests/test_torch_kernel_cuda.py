"""The hand-written MTTKRP kernel (csrc/mttkrp3.cu) on a CUDA card.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3, mttkrp3_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, R, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal(shape)
    return X, [rng.standard_normal((n, R)) for n in shape]


@pytest.mark.parametrize("shape,R", [((37, 50, 29), 7), ((5, 3, 130), 1),
                                     ((64, 96, 80), 20), ((1, 1, 1), 32),
                                     ((3, 700, 300), 16)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_mttkrp3_kernel_matches_plain(cuda_device, shape, R, mode):
    """float64 to 1e-12 and float32 to 1e-4 of the largest entry: float32
    sums of up to J*K terms in another order than the plain version."""
    X, facs = _inputs(shape, R)
    want = mttkrp3_reference(torch.tensor(X), [torch.tensor(f) for f in facs],
                             mode)
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        Xc = torch.tensor(X, dtype=dt, device=cuda_device)
        fc = [torch.tensor(f, dtype=dt, device=cuda_device) for f in facs]
        before = mttkrp3.launches
        got = mttkrp3(Xc, fc, mode)
        torch.cuda.synchronize()
        assert mttkrp3.launches == before + 1
        assert got.dtype == dt and got.shape == (shape[mode], R)
        err = (got.double().cpu() - want).abs().max().item()
        assert err <= tol * want.abs().max().item()
        assert torch.equal(mttkrp3(Xc, fc, mode), got)   # deterministic


def test_torch_mttkrp3_kernel_rejects_what_it_does_not_take(cuda_device):
    X, facs = _inputs((4, 5, 6), 3)
    Xc = torch.tensor(X, device=cuda_device)
    fc = [torch.tensor(f, device=cuda_device) for f in facs]
    with pytest.raises(ValueError, match="contiguous"):
        mttkrp3(Xc.transpose(0, 1), [fc[1], fc[0], fc[2]], 0)
    with pytest.raises(ValueError):
        mttkrp3(Xc, [fc[0], fc[1].float(), fc[2]], 0)
    with pytest.raises(ValueError):
        mttkrp3(Xc, [fc[0], fc[1].cpu(), fc[2]], 0)
    with pytest.raises(ValueError, match="R <= 32"):
        big = [torch.zeros((n, 33), dtype=torch.float64, device=cuda_device)
               for n in (4, 5, 6)]
        mttkrp3(Xc, big, 1)
    with pytest.raises(ValueError):
        mttkrp3(Xc.half(), [f.half() for f in fc], 2)


def test_torch_fit_on_cuda_runs_the_kernel_and_matches_cpu(cuda_device):
    """A small type-4 coupled fit: float64 on the card through the kernel
    against float64 on the CPU through the plain einsum."""
    from matlab_code_tpu_torch import AlgOptions, fit
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.utils import flagship

    spec, data = flagship.build_problem("cpu", torch.float64)
    state0 = init_coupled(spec, data, flagship.flagship_init_options(), seed=3)
    opts = AlgOptions(MaxOuterIters=3, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_cpu = fit(spec, data, state0, opts)
    spec_g, data_g = flagship.build_problem(cuda_device, torch.float64)
    before = mttkrp3.launches
    _, out_gpu = fit(spec_g, data_g,
                     state_from_numpy(state_to_numpy(state0), cuda_device,
                                      torch.float64), opts)
    assert mttkrp3.launches - before == 2 + 6 * 3
    np.testing.assert_allclose(out_gpu.func_val_conv, out_cpu.func_val_conv,
                               rtol=1e-9)
    np.testing.assert_allclose(out_gpu.func_coupl_conv, out_cpu.func_coupl_conv,
                               rtol=1e-8)
