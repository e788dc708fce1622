"""The example scripts on a CUDA card against the CPU, and
matmul_precision='bfloat16' on the card.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_examples_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.examples import run_all
from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
from matlab_code_tpu_torch.ops.prox_cuda import project_isotonic_cols
from matlab_code_tpu_torch.options import BF16_ON_CUDA

pytestmark = pytest.mark.cuda

ZERO = dict(AbsFuncTol=0.0, OuterRelTol=0.0, MaxOuterIters=10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name,counter", [
    ("script03_matrix_cp_partialcoupling", mttkrp3),
    ("script09_par2_unimodality", project_isotonic_cols)])
def test_torch_example_replay_on_card_matches_cpu(cuda_device, name, counter):
    """A CP replay (script 03: type 4, the non-negative l2-sphere) and a
    PARAFAC2 one (script 09: the unimodal Bk prox, kernel A, in the init),
    data and init drawn by the port on the MATLAB stream, 10 iterations in
    float64, each device on its default par2_polar 'auto' ('ns' on the
    card, 'svd' on the CPU): the card's objective stream against the CPU's
    at rtol 1e-8, each final factor within 1e-8 of its largest entry, the
    inner iterations equal."""
    mod = run_all.module(name)
    cpu = mod.run_reference(verbose=False, device="cpu", **ZERO)
    counter.launches = 0
    gpu = mod.run_reference(verbose=False, device=cuda_device,
                            dtype=torch.float64, **ZERO)
    assert counter.launches > 0
    assert gpu["data"].objects[0].device.type == "cuda"
    np.testing.assert_allclose(gpu["out"].func_val_conv,
                               cpu["out"].func_val_conv, rtol=1e-8, atol=0)
    np.testing.assert_array_equal(gpu["out"].innerIters,
                                  cpu["out"].innerIters)
    for g, c in zip(gpu["state"].fac, cpu["state"].fac):
        assert float((g.cpu() - c).abs().max()) <= 1e-8 * float(c.abs().max())


def test_torch_bfloat16_on_card_raises_and_restores(cuda_device):
    """On the card 'bfloat16' raises with the measured reason and leaves
    torch's TF32 switches and float32 matmul precision as the caller set
    them; 'tensorfloat32' holds only inside the fit."""
    cfg = run_all.module("script06_three_datasets").build(small=True)
    for flags in ((False, False), (True, True)):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        precision = torch.get_float32_matmul_precision()
        for mp in ("bfloat16", "tensorfloat32"):
            cfg["opts"] = tp.AlgOptions(MaxOuterIters=2, matmul_precision=mp)
            if mp == "bfloat16":
                with pytest.raises(NotImplementedError) as e:
                    run_all.module("script06_three_datasets").run(
                        **cfg, device=cuda_device, verbose=False)
                assert str(e.value) == BF16_ON_CUDA
            else:
                run_all.module("script06_three_datasets").run(
                    **cfg, device=cuda_device, verbose=False)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
            assert torch.get_float32_matmul_precision() == precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _colmajor(t):
    """The same values in the reversed dimension order's memory layout."""
    dims = tuple(range(t.dim()))[::-1]
    return t.permute(dims).contiguous().permute(dims)


@pytest.mark.parametrize("name", ["script06_three_datasets",
                                  "script12_cp_par2_em"])
def test_torch_fit_takes_column_major_inputs_on_card(cuda_device, name):
    """An init whose factors, or a missing-data mask that, is not
    row-major (as torch.tensor makes of a Fortran-ordered numpy array, the
    MATLAB stream's layout) fits on the card through the dense kernel to
    the row-major inputs' result (rtol 1e-12: cuBLAS may sum a product of
    the transposed layout in another order)."""
    from matlab_code_tpu_torch.examples.common import _setup
    from matlab_code_tpu_torch.models.init import init_coupled
    cfg = run_all.module(name).build(small=True)
    data, _, _, init = _setup(
        cfg["spec"], cfg["lambdas"], cfg["distr"], 0.1, None, None, None, 0,
        "shift", None, True, cfg.get("miss_fraction"), device=cuda_device,
        dtype=torch.float64)
    state = init_coupled(cfg["spec"], data, init, seed=2)
    cols = state.replace(fac=tuple(_colmajor(f) for f in state.fac))
    data_c = data
    if cfg.get("miss_fraction"):
        data_c = dataclasses.replace(
            data, miss=tuple(_colmajor(m) for m in data.miss))
        assert not data_c.miss[0].is_contiguous()
    assert not all(f.is_contiguous() for f in cols.fac)
    opts = tp.AlgOptions(MaxOuterIters=3, AbsFuncTol=0.0, OuterRelTol=0.0)
    mttkrp3.launches = 0
    st_a, out_a = tp.fit(cfg["spec"], data, state, opts)
    st_b, out_b = tp.fit(cfg["spec"], data_c, cols, opts)
    assert mttkrp3.launches > 0
    np.testing.assert_allclose(out_b.func_val_conv, out_a.func_val_conv,
                               rtol=1e-12, atol=0)
    for a, b in zip(st_a.fac, st_b.fac):
        torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-15)
