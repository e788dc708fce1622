"""The port's fit against the JAX package: the pinned golden trajectories
of the coupled CP configurations, and the flagship workload against
bench.py's.  The helpers here (_jax_problem, _to_port, _golden_problem)
serve the other test_torch_* files that compare fits.

Data and init state come from the JAX package and cross to the port as
numpy arrays (matlab_code_tpu_torch.convert); everything runs in float64 on
the CPU.
"""
import os

import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import bench
import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, spec_from_reference, state_from_numpy)
from matlab_code_tpu_torch.models.solver import fit as tfit
from matlab_code_tpu_torch.utils import flagship

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# One torch CPU thread for the port's tests: a test run with several
# workers shares the machine's cores, and torch's idle OpenMP threads spin
# there and slow every other worker (the JAX package's shard tests most).
# Every worker imports this module when it collects the tests, so the
# setting holds for the whole run.
torch.set_num_threads(1)


def _golden_config(name):
    """The specs of tests/test_golden_trajectories.py for the coupled CP
    goldens this slice covers."""
    NN = ConstraintSpec("non-negativity")
    if name == "cp_nonneg_coupled":
        spec = ProblemSpec(
            mode_sizes=(10, 11, 12, 10, 13),
            datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                                  weight=0.5),
                      DatasetSpec(model="CP", modes=(3, 4), rank=2,
                                  weight=0.5)),
            coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                                  coupling_type=(0,)),
            constraints=(NN, None, None, NN, None))
        return spec, None
    spec = ProblemSpec(
        mode_sizes=(11, 11, 12, 11, 13),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN, None, None, NN, None))
    trafo = [np.eye(3), None, None, np.vstack([np.eye(2), np.zeros((1, 2))]),
             None]
    return spec, trafo


def _jax_problem(name):
    spec, trafo = _golden_config(name)
    lambdas = [[1] * ds.rank for ds in spec.datasets]
    data, _, _, _ = create_coupled_data(
        spec, lambdas=lambdas, noise=0.05,
        distr=["rand", "randn", "randn", "rand", "randn"], rng=11,
        coupl_trafo=trafo)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "randn", "rand", "randn"),
                       normalize=True,
                       lambdas_init=tuple(tuple(l) for l in lambdas))
    return spec, data, init_coupled(spec, data, init, key=7)


def _to_port(spec, data, state):
    return (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            state_from_numpy(state, device="cpu"))


class _AtFit(Exception):
    """Raised in place of the JAX fit, carrying its spec, data and state."""


def _golden_problem(name, monkeypatch):
    """The spec, data and init state of a golden of
    tests/test_golden_trajectories.py, taken from its _run_config where it
    would call the JAX fit (so the configuration is that file's own)."""
    import test_golden_trajectories as gt

    def at_fit(spec, data, state0, opts):
        raise _AtFit(spec, data, state0)

    monkeypatch.setattr(gt, "fit", at_fit)
    with pytest.raises(_AtFit) as caught:
        gt._run_config(name)
    return caught.value.args


@pytest.mark.parametrize("name", [
    "cp_nonneg_coupled", "coupled_type4", "coupled_type1", "coupled_type2",
    "coupled_type3", "coupled_type5", "cp_tv"])
def test_torch_fit_reproduces_golden(name, monkeypatch):
    if name in ("cp_nonneg_coupled", "coupled_type4"):
        spec, data, state0 = _to_port(*_jax_problem(name))
    else:
        spec, data, state0 = _to_port(*_golden_problem(name, monkeypatch))
    opts = tp.AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out = tfit(spec, data, state0, opts)
    traj = np.stack([out.func_val_conv, out.func_coupl_conv,
                     out.func_constr_conv, out.func_PAR2_coupl])
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["traj"]
    # the goldens' own tolerance (tests/test_golden_trajectories.py)
    np.testing.assert_allclose(traj, want, rtol=1e-8, atol=1e-12)


def test_torch_flagship_is_bench_workload():
    """utils/flagship.py rebuilds bench.py's flagship without jax: the same
    sizes, ranks, selectors and ground truth, assembled contiguous and
    normalised."""
    assert (flagship.S, flagship.RTOT, flagship.R1, flagship.R2, flagship.R3,
            flagship.N_ITERS) == (bench.S, bench.RTOT, bench.R1, bench.R2,
                                  bench.R3, bench.N_ITERS)
    (H, Delta, f) = flagship._flagship_truth(np.float64)
    (Hb, Deltab, fb) = bench._flagship_truth()
    for a, b in zip(H, Hb):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(Delta, Deltab)
    assert f.keys() == fb.keys()
    for m in f:
        np.testing.assert_array_equal(f[m], fb[m])
    spec, data = flagship.build_problem("cpu", torch.float32)
    assert spec.mode_sizes == (128, 512, 256, 128, 1024, 64, 128, 4096)
    assert [ds.rank for ds in spec.datasets] == [16, 20, 20]
    assert spec.coupling.coupling_type == (4,)
    for X in data.objects:
        assert X.is_contiguous() and X.dtype == torch.float32
        assert abs(float(torch.linalg.norm(X)) - 1.0) < 1e-5
    tp.check_data_input(spec, data)
