"""The port's example runner on the CPU (matlab_code_tpu_torch/examples/):
run(**build(small=True)) of six scripts, held to the recovery thresholds
tests/test_examples.py holds their JAX twins to (the port draws its own
init, init_coupled(..., seed=key), so the fit is held to the scripts'
outcomes, not to the JAX fit); the runner's refusal without a card; and
matmul_precision='bfloat16' on the CPU giving 'default''s bits.  Float64.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.examples import run_all
from matlab_code_tpu_torch.options import apply_matmul_precision

torch.set_num_threads(1)     # as tests/test_torch_solver.py: xdist workers


def _run(name):
    res = run_all.run_script(name, small=True, device="cpu", verbose=False)
    assert res["data"].objects[0].dtype == torch.float64
    return res


def _unimodal(Z):
    for k in range(Z.shape[0]):
        for r in range(Z.shape[2]):
            col = Z[k, :, r]
            peak = int(np.argmax(col))
            assert np.all(np.diff(col[:peak + 1]) >= -1e-8)
            assert np.all(np.diff(col[peak:]) <= 1e-8)


def _check(name, res):
    rep = res["report"]
    if name.startswith("script01"):
        fit, fms_cp = rep[0]
        assert fit > 99.9 and fms_cp > 0.99
        fitp, sA, sB, sC = rep[1]
        assert fitp > 99.9 and sA > 0.99 and sC > 0.99
    elif name.startswith("script05"):
        assert rep[0][0] > 99.0 and rep[1][0] > 99.0
        Z = res["state"].constraint_fac[5].numpy()   # the simplex holds
        np.testing.assert_allclose(Z.sum(axis=0), 1.0, atol=1e-6)
        assert Z.min() >= -1e-10
    elif name.startswith("script09"):
        assert rep[0][0] > 95.0
        _unimodal(res["state"].constraint_fac[1].numpy())
    elif name.startswith("script10"):
        assert rep[0][1] > 0.98
    elif name.startswith("script11"):
        fitp, sA, sB, sC = rep[0]
        assert fitp > 95.0 and sB > 0.95
    else:                                            # script 12, EM
        assert res["out"].f_rel_missing < 1e-4
        assert rep[0][1] > 0.99 and rep[1][1] > 0.99
        assert all(m is not None for m in res["data"].miss)


@pytest.mark.parametrize("name", [
    "script01_cp_par2_nonneg", "script05_cp_cp_doublesampling_simplex",
    "script09_par2_unimodality", "script10_cp_tv", "script11_tparafac2",
    "script12_cp_par2_em"])
def test_torch_example_recovers(name):
    _check(name, _run(name))


def test_torch_run_all_refuses_without_a_card():
    """Without a card the runner exits non-zero before any fit unless
    --device cpu is given (a fresh interpreter: the module's entry point)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the runner runs there")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "matlab_code_tpu_torch.examples.run_all"],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr and "===" not in proc.stdout
    with pytest.raises(SystemExit, match="no CUDA card"):
        run_all.main(["--full", "--replay"])
    assert set(run_all.REPLAYS) == set(run_all.SCRIPTS) - {
        "script07_matrix_cp_kl", "script11_tparafac2", "script15_realdata"}


def test_torch_bfloat16_on_the_cpu_is_default():
    """matmul_precision='bfloat16' on CPU data computes what 'default'
    computes, bit for bit (the JAX package's CPU products ignore it), and
    leaves torch's TF32 switches as they were; on a card it raises with the
    measured reason (options.BF16_ON_CUDA)."""
    cfg = run_all.module("script01_cp_par2_nonneg").build(small=True)
    opts = dataclasses.replace(cfg["opts"], MaxOuterIters=8)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    outs = []
    for mp in ("bfloat16", "default"):
        cfg["opts"] = dataclasses.replace(opts, matmul_precision=mp)
        res = run_all.module("script01_cp_par2_nonneg").run(
            **cfg, device="cpu", verbose=False)
        outs.append(res)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == saved
    a, b = outs
    np.testing.assert_array_equal(a["out"].func_val_conv,
                                  b["out"].func_val_conv)
    for x, y in zip(a["state"].fac, b["state"].fac):
        assert torch.equal(x, y)
    with pytest.raises(NotImplementedError, match="TF32"):
        apply_matmul_precision(tp.AlgOptions(matmul_precision="bfloat16"),
                               "cuda")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        apply_matmul_precision(tp.AlgOptions(matmul_precision="bfloat16"))
