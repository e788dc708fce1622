"""The port's own reference-seeded replays of the example scripts
(matlab_code_tpu_torch/examples/script*.run_reference on the CPU in
float64): data, masks and init drawn on the MATLAB twister stream by the
port (utils/matlab_rng.py), the fit by the port, no JAX-package data and no
monkeypatch.  Each objective stream must reproduce its pinned golden,
tests/golden/reference_seeded_*.npz, at tests/test_fixture_parity.py's
tolerance (rtol 1e-9, atol 1e-12).  Collected by
test_torch_examples_replays_{a,b}.py.

A replay that takes more than ~20 s here is cut to its first N outer
iterations (MaxOuterIters = N, tests/test_torch_parafac2_replays.py's
caps) and held on the first N + 1 entries of the golden; a full replay
must stop before MaxOuterIters and recover the truth (every FMS above the
stated bound).
"""
import importlib
import os

import numpy as np
import torch

torch.set_num_threads(1)     # as tests/test_torch_solver.py: xdist workers

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# (script, golden, N or None for the full run, least FMS of a full run)
PAR2 = [
    ("script01_cp_par2_nonneg", "script1", None, 0.99),
    ("script02_matrix_par2_nonneg", "script02", None, 0.94),   # noise 0.5
    ("script14_cp_par2_couplC", "script14", None, 0.99),
    ("script04_irregular_par2", "script04", 120, None),      # of 235
    ("script08_regular_par2_nonneg", "script08", 150, None),  # of 308
    ("script09_par2_unimodality", "script09", 120, None),    # of 260; Bk from 100
    ("script01a_cp_par2_smooth_l2ball", "script01a", 120, None),  # of 4000
]
CP = [
    ("script03_matrix_cp_partialcoupling", "script03", None, 0.99),
    ("script05_cp_cp_doublesampling_simplex", "script05", None, 0.99),
    ("script06_three_datasets", "script06", None, 0.99),
    ("script10_cp_tv", "script10", None, 0.99),
    ("script12_cp_par2_em", "script12", None, 0.99),
    ("script13_cp_cp_type5", "script13", None, 0.999),
]


def hold_replay(mod, golden, N, least_fms):
    from matlab_code_tpu_torch.models.solver import FitOutput
    cap = {} if N is None else {"MaxOuterIters": N}
    res = importlib.import_module(
        f"matlab_code_tpu_torch.examples.{mod}").run_reference(
            verbose=False, device="cpu", **cap)
    out = res["out"]
    assert isinstance(out, FitOutput)
    assert res["data"].objects[0].dtype == torch.float64
    want = np.load(os.path.join(GOLDEN_DIR, f"reference_seeded_{golden}.npz"))[
        "func_val_conv"]
    traj = out.func_val_conv
    if N is None:
        assert out.exit_flag != "maxIterations"
        assert len(traj) == len(want)
        scores = [s for rep in res["report"].values() for s in rep[1:]]
        assert min(scores) > least_fms, res["report"]
    else:
        assert len(traj) == N + 1 <= len(want)
        want = want[:N + 1]
    np.testing.assert_allclose(traj, want, rtol=1e-9, atol=1e-12)
    return res
