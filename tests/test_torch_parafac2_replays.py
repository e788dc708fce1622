"""The MATLAB-seeded replays of the PARAFAC2 example scripts (1, 01a, 02,
04, 08, 09, 11 and 14) with the port doing the fit: the data and init come
from the reference's exact twister stream (examples/common.
run_reference_seeded; script 11's from its shipped .mat fixtures), the
port's cmtf_aoadmm (fit, for script 11) stands in for the JAX package's,
and the objective stream must reproduce the pinned golden at
tests/test_fixture_parity.py's tolerance (rtol 1e-9, atol 1e-12).

A replay that takes more than ~20 s here is cut to its first N outer
iterations (MaxOuterIters = N) and held on the first N + 1 entries of the
golden; N is stated beside each.  Script 9's N passes its delayed Bk
constraint (iter_start_PAR2Bkconstraint = 100).
"""
import dataclasses
import importlib
import os

import numpy as np
import pytest

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy)
from examples.script11_tparafac2 import FIXTURE_DIR as FIXTURE
from test_torch_solver import GOLDEN_DIR


def _port_fit(N):
    """The port's fit on a JAX-package problem, MaxOuterIters cut to N."""
    def run(spec, data, options, init):
        opts = options_from_reference(options)
        if N is not None:
            opts = dataclasses.replace(opts, MaxOuterIters=N)
        return tp.fit(spec_from_reference(spec),
                      data_from_numpy(data.objects, data.coupl_trafo,
                                      data.coupl_trafo2, device="cpu"),
                      state_from_numpy(init, device="cpu"), opts), opts
    return run


def _hold(traj, golden, N):
    want = np.load(os.path.join(GOLDEN_DIR, golden))["func_val_conv"]
    if N is None:
        assert len(traj) == len(want)
    else:
        assert len(traj) == N + 1 <= len(want)
        want = want[:N + 1]
    np.testing.assert_allclose(traj, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("mod,golden,N", [
    ("script01_cp_par2_nonneg", "script1", None),
    ("script02_matrix_par2_nonneg", "script02", None),
    ("script14_cp_par2_couplC", "script14", None),
    ("script04_irregular_par2", "script04", 120),    # of 235 iterations
    ("script08_regular_par2_nonneg", "script08", 150),   # of 308
    ("script09_par2_unimodality", "script09", 120),  # of 260; Bk from 100
    ("script01a_cp_par2_smooth_l2ball", "script01a", 120),   # of 4000
])
def test_torch_par2_reference_seeded_replay(mod, golden, N, monkeypatch):
    import matlab_code_tpu.models.solver as jsolver
    fit = _port_fit(N)
    ran = {}

    def port_cmtf_aoadmm(spec, data, options, init=None, **kw):
        (state, out), opts = fit(spec, data, options, init)
        ran["opts"] = opts
        tspec = spec_from_reference(spec)
        return tp.models.solver.assemble_zhat(tspec, state), state, init, out

    monkeypatch.setattr(jsolver, "cmtf_aoadmm", port_cmtf_aoadmm)
    res = importlib.import_module(f"examples.{mod}").run_reference(
        verbose=False)
    out = res["out"]
    assert isinstance(out, tp.models.solver.FitOutput)
    if mod.startswith("script09"):
        assert ran["opts"].iter_start_PAR2Bkconstraint == 100 < N
    if N is None:
        assert out.exit_flag != "maxIterations"
    _hold(out.func_val_conv, f"reference_seeded_{golden}.npz", N)


def test_torch_script11_reference_seeded_replay(monkeypatch):
    """Script 11 (tPARAFAC2, eta 1000, ridge 100 on A and C) on the shipped
    .mat data with the bit-exact rng("default") init, the port's fit
    standing in for the JAX one; first N = 300 of its 1850 iterations."""
    if not os.path.exists(os.path.join(FIXTURE, "gnd_factors.mat")):
        pytest.skip("reference fixture data not mounted")
    import matlab_code_tpu.models.solver as jsolver
    fit = _port_fit(300)
    monkeypatch.setattr(jsolver, "fit",
                        lambda spec, data, state0, opts: fit(
                            spec, data, opts, state0)[0])
    from examples.script11_tparafac2 import run_real
    res = run_real(fixture_dir=FIXTURE, verbose=False, reference_init=True)
    _hold(res["out"].func_val_conv, "reference_seeded_script11.npz", 300)
