"""The port's EM fits against the JAX package (continued from
test_torch_em.py): the EM fits of tests/test_losses_missing.py run to their
tolerances through both packages, float64 on the CPU.
"""
import numpy as np
import pytest

from matlab_code_tpu import AlgOptions
from matlab_code_tpu.models import solver as jsolver

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import options_from_reference, state_from_numpy
from test_torch_em import (
    STREAMS, em_cp, em_par2, em_par2_ragged, em_telemetry, to_port)


def _hold_fit(out, ref):
    assert out.OuterIterations == ref.OuterIterations
    for s in STREAMS:
        np.testing.assert_allclose(getattr(out, s), getattr(ref, s),
                                   rtol=1e-8, atol=1e-12, err_msg=s)
    np.testing.assert_array_equal(out.innerIters, ref.innerIters)
    np.testing.assert_allclose(out.f_rel_missing, ref.f_rel_missing,
                               rtol=1e-8, atol=1e-12)
    assert out.exit_flag == ref.exit_flag


@pytest.mark.parametrize("case,opts", [
    ("cp", AlgOptions(MaxOuterIters=2000, AbsFuncTol=1e-10, OuterRelTol=1e-9)),
    ("par2", AlgOptions(MaxOuterIters=2000, AbsFuncTol=1e-9, OuterRelTol=1e-8)),
    ("telemetry", AlgOptions(MaxOuterIters=60, AbsFuncTol=1e-12,
                             OuterRelTol=1e-12)),
    ("par2_ragged", AlgOptions(MaxOuterIters=30, AbsFuncTol=0.0,
                               OuterRelTol=0.0)),
])
def test_torch_em_fit_matches_jax(case, opts):
    """The EM fits of tests/test_losses_missing.py (test_missing_data_em_cp,
    _par2 and the telemetry test) through the JAX fit and the port's, to
    their own tolerances: the same iterations and exit, every stream with
    func_rel_missing at rtol 1e-8, innerIters equal; the telemetry case
    also holds the port's fit_stepwise to its fit and the telemetry
    fields' shapes (func_rel_missing NaN at iteration 0 only).  The ragged
    PARAFAC2 case (padded columns marked missing) runs 30 iterations and
    keeps its padded columns and Bk rows exactly zero."""
    build = {"cp": em_cp, "par2": em_par2, "telemetry": em_telemetry,
             "par2_ragged": em_par2_ragged}[case]
    spec, data, state0 = build()
    _, ref = jsolver.fit(spec, data, state0, opts)
    tspec, tdata, tstate0 = to_port(spec, data, state0)
    topts = options_from_reference(opts)
    st, out = tp.fit(tspec, tdata, tstate0, topts)
    _hold_fit(out, ref)
    if case == "par2_ragged":
        for k, J in enumerate(spec.mode_sizes[1]):
            assert not bool(st.fac[1][k, J:].any())
        return
    if case != "telemetry":
        assert out.exit_flag != "maxIterations" and out.f_rel_missing < 1e-5
        return
    _, sw = tp.fit_stepwise(tspec, tdata, state_from_numpy(state0, "cpu"),
                            topts)
    _hold_fit(sw, ref)
    for o in (out, sw):
        n = o.OuterIterations
        assert len(o.func_rel_missing) == len(o.time_at_it) == n + 1
        assert np.isnan(o.func_rel_missing[0])
        assert np.all(np.isfinite(o.func_rel_missing[1:]))
        assert np.all(np.diff(o.time_at_it) >= 0)
        assert o.f_rel_missing == o.func_rel_missing[-1]
