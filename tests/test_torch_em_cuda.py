"""EM imputation, the pairwise-perturbation MTTKRP, fit_stepwise and
checkpoints on a CUDA card against the CPU in float64.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_em_cuda.py
"""
import numpy as np
import pytest
import torch

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
from matlab_code_tpu_torch.models import pairwise
from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
from matlab_code_tpu_torch.ops.sparse_cuda import mttkrp_sparse_cuda
from matlab_code_tpu_torch.state import FIELDS
from matlab_code_tpu_torch.utils import em_workload as emw

pytestmark = pytest.mark.cuda

STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hold(gpu, cpu, streams=STREAMS):
    assert gpu.OuterIterations == cpu.OuterIterations
    for s in streams:
        np.testing.assert_allclose(getattr(gpu, s), getattr(cpu, s),
                                   rtol=1e-8, atol=1e-12, err_msg=s)
    np.testing.assert_array_equal(gpu.innerIters, cpu.innerIters)


def test_torch_em_fit_on_card_matches_cpu(cuda_device):
    """Script 12's widths (CP and PARAFAC2, 20 % missing, type 0), 3
    iterations in float64: the card's five streams against the CPU's at
    rtol 1e-8, innerIters equal, mttkrp3 launched on the imputed CP
    tensor."""
    spec, data_c, opts, init = emw.script12_problem("cpu", torch.float64)
    _, data_g, _, _ = emw.script12_problem(cuda_device, torch.float64)
    init_np = state_to_numpy(tp.init_coupled(spec, data_c, init, seed=2))
    o3 = tp.AlgOptions(MaxOuterIters=3, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, cpu = tp.fit(spec, data_c, state_from_numpy(init_np, "cpu"), o3)
    before = mttkrp3.launches
    _, gpu = tp.fit(spec, data_g, state_from_numpy(init_np, cuda_device), o3)
    assert mttkrp3.launches >= before + 3 * 3
    _hold(gpu, cpu, STREAMS + ("func_rel_missing",))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_torch_pp_fit_on_card_matches_cpu(cuda_device, layout):
    """tests/test_pairwise.py's problem with cp_pairwise_perturbation, 40
    iterations in float64: the streams at rtol 1e-8, the same sweep
    switching the approximation on and as many rebuilds; the exact sweeps
    ran the dense or the sparse kernel."""
    spec, data_c, init = emw.pp_problem(layout, "cpu")
    _, data_g, _ = emw.pp_problem(layout, cuda_device)
    init_np = state_to_numpy(tp.init_coupled(spec, data_c, init, seed=1))
    opts = tp.AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0,
                         cp_pairwise_perturbation=True)
    pairwise.reset_counts()
    _, cpu = tp.fit(spec, data_c, state_from_numpy(init_np, "cpu"), opts)
    counts = (pairwise.pp_sweep_update.first_active,
              pairwise.pp_sweep_update.rebuilds)
    pairwise.reset_counts()
    kernel = mttkrp3 if layout == "dense" else mttkrp_sparse_cuda
    before = kernel.launches
    _, gpu = tp.fit(spec, data_g, state_from_numpy(init_np, cuda_device), opts)
    assert counts[0] is not None and counts[0] < 40
    assert (pairwise.pp_sweep_update.first_active,
            pairwise.pp_sweep_update.rebuilds) == counts
    assert kernel.launches > before
    _hold(gpu, cpu)


def test_torch_stepwise_on_card_matches_fit(cuda_device):
    """fit_stepwise and fit on the card in float64 from one init: the same
    iterations and streams at rtol 1e-12."""
    spec, data, init = emw.pp_problem("dense", cuda_device)
    st0 = tp.init_coupled(spec, data, init, seed=1)
    opts = tp.AlgOptions(MaxOuterIters=20, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, o1 = tp.fit(spec, data, st0, opts)
    _, o2 = tp.fit_stepwise(spec, data, st0, opts)
    assert o1.OuterIterations == o2.OuterIterations == 20
    for s in STREAMS:
        np.testing.assert_allclose(getattr(o2, s), getattr(o1, s), rtol=1e-12,
                                   atol=1e-15)


def test_torch_load_state_defaults_to_the_card(cuda_device, tmp_path):
    """load_state puts every field on the card unless asked for the CPU,
    bit for bit, PARAFAC2's P, DeltaB and mu_DeltaB included."""
    spec, data, _, init = emw.script12_problem(cuda_device, torch.float32)
    st = tp.init_coupled(spec, data, init, seed=2)
    path = str(tmp_path / "state.npz")
    tp.save_state(path, st)
    back = tp.load_state(path)
    for f in FIELDS:
        for a, b in zip(getattr(st, f), getattr(back, f)):
            assert (a is None) == (b is None)
            if a is not None:
                assert b.device.type == "cuda" and torch.equal(a, b)
    assert back.P[1] is not None and back.DeltaB[1] is not None
