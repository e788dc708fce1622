"""The hand-written sparse COO MTTKRP kernel (csrc/mttkrp_sparse.cu) on a
CUDA card.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_sparse_cuda.py
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.ops.sparse_cuda import (
    CHUNK, build_plan, mttkrp_sparse_cuda, mttkrp_sparse_reference)
from matlab_code_tpu_torch.ops.tensor import mttkrp_sparse

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _coo(shape, nnz, seed=4, duplicates=0, long_row=0):
    """Coordinates drawn at even indices only (so every mode has empty
    rows), plus `duplicates` repeated coordinates and one mode-0 row of
    `long_row` extra nonzeros; normal values."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, (d + 1) // 2, nnz) * 2 for d in shape], 1)
    idx = np.concatenate([idx, idx[:duplicates]])
    extra = np.stack([rng.integers(0, (d + 1) // 2, long_row) * 2
                      for d in shape], 1)
    extra[:, 0] = 0
    idx = np.concatenate([idx, extra]).astype(np.int32)
    return idx, rng.standard_normal(len(idx)), rng


@pytest.mark.parametrize("shape,nnz,R,duplicates,long_row", [
    ((300, 257, 129), 20000, 7, 0, 0),
    ((40, 23, 17), 3000, 40, 500, 12 * CHUNK),   # R > 32, duplicates, long row
    ((64, 64, 64), 5000, 16, 100, 0),
    ((50, 30), 800, 1, 50, 3 * CHUNK),            # a matrix: one gathered mode
    ((9, 8, 7, 6), 1500, 20, 40, 0),              # four-way: three gathered
])
def test_torch_mttkrp_sparse_kernel_matches_plain(cuda_device, shape, nnz, R,
                                                  duplicates, long_row):
    """float64 to 1e-12 and float32 to 1e-4 of the largest entry of the
    float64 plain result: sums run in another order than index_add_."""
    idx, val, rng = _coo(shape, nnz, duplicates=duplicates, long_row=long_row)
    facs = [rng.standard_normal((d, R)) for d in shape]
    for mode in range(len(shape)):
        want = mttkrp_sparse_reference(
            torch.tensor(idx), torch.tensor(val), [torch.tensor(f) for f in facs],
            mode, shape[mode])
        scale = want.abs().max().item()
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
            plan = build_plan(torch.tensor(idx, device=cuda_device),
                              torch.tensor(val, dtype=dt, device=cuda_device),
                              shape, mode)
            fc = [torch.tensor(f, dtype=dt, device=cuda_device) for f in facs]
            before = mttkrp_sparse_cuda.launches
            got = mttkrp_sparse_cuda(plan, fc)
            torch.cuda.synchronize()
            assert mttkrp_sparse_cuda.launches == before + 1
            assert got.dtype == dt and got.shape == (shape[mode], R)
            assert (got.double().cpu() - want).abs().max().item() <= tol * scale
            assert torch.equal(mttkrp_sparse_cuda(plan, fc), got)  # same bits


def test_torch_mttkrp_sparse_kernel_rejects_what_it_does_not_take(cuda_device):
    shape = (6, 5, 4)
    idx, val, rng = _coo(shape, 40)
    vc = torch.tensor(val, device=cuda_device)
    ic = torch.tensor(idx, device=cuda_device)
    fc = [torch.tensor(rng.standard_normal((d, 3)), device=cuda_device)
          for d in shape]
    plan = build_plan(ic, vc, shape, 0)
    with pytest.raises(ValueError):
        mttkrp_sparse_cuda(plan, [fc[0], fc[1].cpu(), fc[2]])
    with pytest.raises(ValueError):
        mttkrp_sparse_cuda(plan, [fc[0], fc[1].float(), fc[2]])
    with pytest.raises(ValueError, match="contiguous"):
        mttkrp_sparse_cuda(plan, [fc[0], fc[1], fc[2].T.contiguous().T])
    with pytest.raises(ValueError, match="plan"):
        mttkrp_sparse(ic, vc, fc, 0, shape[0])                 # no plan
    with pytest.raises(ValueError, match="plan is for mode 0"):
        mttkrp_sparse(ic, vc, fc, 1, shape[1], plan=plan)
    half = build_plan(ic, vc.half(), shape, 0)
    with pytest.raises(ValueError, match="float32 or float64"):
        mttkrp_sparse_cuda(half, [f.half() for f in fc])


def test_torch_sparse_fit_on_cuda_runs_the_kernel_and_matches_cpu(cuda_device):
    """A small sparse_workload fit in float64: on the card through the
    kernel (one launch per mode per iteration and one for the initial
    objective) against the CPU through the plain version."""
    from matlab_code_tpu_torch import fit
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.utils import sparse_workload as sw

    iters = 3
    spec, data = sw.build_problem(D=64, NNZ=5000, device="cpu",
                                  dtype=torch.float64)
    state0 = init_coupled(spec, data, sw.sparse_init_options(), seed=3)
    opts = sw.sparse_options(iters, AbsFuncTol=0.0, OuterRelTol=0.0)
    st_cpu, out_cpu = fit(spec, data, state0, opts)
    _, data_g = sw.build_problem(D=64, NNZ=5000, device=cuda_device,
                                 dtype=torch.float64)
    before = mttkrp_sparse_cuda.launches
    st_gpu, out_gpu = fit(spec, data_g,
                          state_from_numpy(state_to_numpy(state0), cuda_device,
                                           torch.float64), opts)
    assert mttkrp_sparse_cuda.launches - before == 3 * iters + 1
    np.testing.assert_allclose(out_gpu.func_val_conv, out_cpu.func_val_conv,
                               rtol=1e-9)
    for m in range(3):
        np.testing.assert_allclose(st_gpu.fac[m].cpu().numpy(),
                                   st_cpu.fac[m].numpy(), rtol=1e-9, atol=1e-12)
