"""utils/profiling.py of the port against matlab_code_tpu/utils/profiling.py:
sweep_flops on CP (dense, a matrix), regular and ragged PARAFAC2 specs;
roofline_report with explicit peaks gives the JAX function's string, and
without them reports against the H100's published peaks, named; Timer;
torch_trace writes a Chrome trace of a CPU run."""
import json
import os

import pytest
import torch

from matlab_code_tpu.utils import profiling as jprof
from matlab_code_tpu_torch import convert
from matlab_code_tpu_torch.utils import profiling as tprof

import torch_mesh_cases as mc

torch.set_num_threads(1)


def _specs():
    return {"type4": mc.type4_flagship()[0], "sparse": mc.sparse_coo()[0],
            "par2": mc.par2_regular()[0], "ragged": mc.par2_ragged()[0],
            "cp_par2": mc.par2_coupled()[0]}


@pytest.mark.parametrize("name", ["type4", "sparse", "par2", "ragged",
                                  "cp_par2"])
def test_torch_sweep_flops_matches_jax(name):
    spec = _specs()[name]
    tspec = convert.spec_from_reference(spec)
    for nbytes in (4, 8):
        assert tprof.sweep_flops(tspec, nbytes) == \
            jprof.sweep_flops(spec, nbytes)


def test_torch_roofline_report_matches_jax_and_names_the_h100():
    spec = mc.par2_ragged()[0]
    tspec = convert.spec_from_reference(spec)
    for peaks in ((9.8e13, 8.2e11), (6.7e13, 3.35e12)):
        assert tprof.roofline_report(tspec, 0.0123, *peaks) == \
            jprof.roofline_report(spec, 0.0123, *peaks)
    got = tprof.roofline_report(tspec, 0.0123)
    want = jprof.roofline_report(spec, 0.0123, peak_flops=6.7e13,
                                 peak_bw=3.35e12)
    assert got == want + "\npeaks: " + tprof.H100_PEAKS
    assert "H100" in tprof.H100_PEAKS
    assert (tprof.H100_F32_FLOP_S, tprof.H100_HBM_BYTES_S) == (6.7e13, 3.35e12)


def test_torch_timer_and_trace_on_the_cpu(tmp_path):
    t = tprof.Timer()
    for _ in range(2):
        with t.phase("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.counts == {"matmul": 2} and t.totals["matmul"] > 0
    assert t.summary().startswith("matmul")
    with tprof.torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
