"""fit_multistart on a CUDA card: the batched-column mttkrp3 call, the
sequential-prox kernels on the start axis, and the starts on the card
against the CPU in float64.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_multistart_cuda.py
"""
import numpy as np
import pytest
import torch

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
from matlab_code_tpu_torch.models.multistart import _fit_lanes
from matlab_code_tpu_torch.ops import prox_cuda
from matlab_code_tpu_torch.ops.isotonic import project_unimodal
from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3, mttkrp3_reference
from matlab_code_tpu_torch.ops.prox import t_smoothness_prox
from matlab_code_tpu_torch.ops.tensor import mttkrp, mttkrp_columns
from matlab_code_tpu_torch.ops.tv import prox_tv
from matlab_code_tpu_torch.utils import par2_surface, surface

pytestmark = pytest.mark.cuda

STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("S,R", [(20, 16), (3, 5), (2, 40)])
def test_torch_mttkrp_columns_on_card(cuda_device, S, R):
    """One mttkrp3 call with S starts' columns side by side, in
    ceil(S R / 32) launches, against each start's plain MTTKRP in float64,
    in every mode, also under the vmap of the start axis."""
    g = torch.Generator(device=cuda_device).manual_seed(S + R)
    shape = (37, 50, 29)
    X = torch.rand(shape, generator=g, device=cuda_device, dtype=torch.float64)
    F = [torch.rand((S, n, R), generator=g, device=cuda_device,
                    dtype=torch.float64) for n in shape]
    for mode in range(3):
        want = torch.stack([mttkrp3_reference(X, [f[s] for f in F], mode)
                            for s in range(S)])
        before = mttkrp3.launches
        got = mttkrp_columns(X, F, mode)
        assert mttkrp3.launches - before == -(-S * R // 32)
        vm = torch.func.vmap(lambda a, b, c: mttkrp(X, [a, b, c], mode))(*F)
        scale = want.abs().max().item()
        for x in (got, vm):
            assert (x - want).abs().max().item() <= 1e-12 * scale


def test_torch_folded_proxes_on_card(cuda_device):
    """Kernels A and B on the start axis (the starts folded into the slice
    axis, one launch) and kernel C (one launch a start): the same bits as
    one call a start."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    S = 4
    V = torch.randn((S, 6, 40, 8), generator=g, device=cuda_device,
                    dtype=torch.float64)
    rho = torch.rand((S, 6), generator=g, device=cuda_device,
                     dtype=torch.float64) + 0.5
    sizes = (40, 31, 17, 40, 2, 33)
    checks = [
        (lambda v: project_unimodal(v, True), (V,),
         prox_cuda.project_isotonic_cols, 1),
        (lambda v: project_unimodal(v, False, sizes), (V,),
         prox_cuda.project_isotonic_cols, 1),
        (lambda v: project_unimodal(v[0], True), (V,),
         prox_cuda.project_isotonic_cols, 1),
        (lambda v, r: prox_tv(v, 0.1 / r[:, None, None]), (V, rho),
         prox_cuda.prox_tv_cols, 1),
        (lambda v, r: t_smoothness_prox(v, r, 2.0), (V, rho),
         prox_cuda.t_smooth_cols, S),
    ]
    for fn, args, kernel, n_launch in checks:
        before = kernel.launches
        got = torch.func.vmap(fn)(*args)
        assert kernel.launches - before == n_launch
        want = torch.stack([fn(*(a[s] for a in args)) for s in range(S)])
        assert torch.equal(got, want)


def _hold(gpu, cpu):
    assert gpu.OuterIterations == cpu.OuterIterations
    np.testing.assert_array_equal(gpu.innerIters, cpu.innerIters)
    for k in STREAMS:
        np.testing.assert_allclose(getattr(gpu, k), getattr(cpu, k),
                                   rtol=1e-8, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("case", ["surface1", "surface5", "par2_tparafac2",
                                  "par2_ragged"])
def test_torch_multistart_on_card_matches_cpu(cuda_device, case):
    """Two starts for 3 iterations in float64 on the card against the CPU:
    the CP surface (kernels A and B on the start axis; types 1 and 5, at
    mode sizes / 8) and the PARAFAC2 surface at 8 slices (tPARAFAC2's
    kernel C; ragged slices with the unimodal Bk)."""
    def build(dev):
        if case.startswith("surface"):
            ctype = int(case[-1])
            spec, data, ds = surface.build_problem(ctype, dev, torch.float64,
                                                   scale=8)
            return spec, data, surface.surface_init_options(ctype), ds
        config = case.split("_")[1]
        spec, data = par2_surface.build_problem(config, dev, torch.float64,
                                                K=8)
        return spec, data, par2_surface.surface_init_options(config), None
    spec, data_c, init, ds = build("cpu")
    _, data_g, _, _ = build(cuda_device)
    opts = tp.AlgOptions(MaxOuterIters=3, MaxInnerIters=5, AbsFuncTol=0.0,
                         OuterRelTol=0.0)
    init_np = [state_to_numpy(tp.init_coupled(spec, data_c, init, seed=k,
                                              delta_shapes=ds))
               for k in range(2)]
    cpu = _fit_lanes(spec, data_c, [state_from_numpy(s, "cpu")
                                    for s in init_np], opts)
    gpu = _fit_lanes(spec, data_g, [state_from_numpy(s, cuda_device)
                                    for s in init_np], opts)
    for a, b in zip(gpu.outs, cpu.outs):
        _hold(a, b)
