"""The control on the card: the program with its TF32 path on
(matmul_precision='tensorfloat32') has to come out not correct by the
cell's limits, where the program as configured comes out correct, on
three seeds, at each cell's own size and job (the readings behind the
limits come from calibrate.py; PERF.md lists them)."""
import pytest
import torch

from cardbench.harness import ROOT, Cell, job_keys, load_json

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


def _over(reading, limits):
    return any(reading[k] > limits[k]["limit"] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    c = Cell(cell)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        readings = {}
        for precision in ("default", "tensorfloat32"):
            spec, data, options, init, _ = c.problem(
                seed, "cuda", matmul_precision=precision)
            job = c.run_job(spec, data, options, init,
                            job_keys(seed, 0, c.traffic["n_starts"]))
            del spec, data
            readings[precision] = c.check(seed, "cuda", options, job)
        assert not _over(readings["default"], c.limits), readings
        assert _over(readings["tensorfloat32"], c.limits), readings
