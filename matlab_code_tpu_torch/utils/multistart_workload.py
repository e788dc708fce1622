"""The multi-start configurations (models/multistart.fit_multistart): the
reference's best-of-N protocol (example_script15.m:113-135) at two sizes.

  script15_problem  example script 15's configuration at its widths
      (examples/script15_realdata.py build()): three CP datasets sharing
      the sample mode, an EEM-like 28 x 60 x 30 tensor of rank 3, an
      NMR-like 28 x 80 x 16 tensor of rank 5 and an LCMS-like 28 x 120
      matrix of rank 5, weights 1/3, the sample modes coupled by type 4
      through script 15's selector matrices (Delta has 6 columns; EEM takes
      components 1-3, NMR 1-5, LCMS 1-4 and 6), every mode non-negative,
      noise 0.03, each dataset of norm 1; the script's options
      (MaxInnerIters 5, AbsFuncTol 1e-4, OuterRelTol 1e-10, 1000 outer
      iterations as its small run) and N_STARTS starts.  The data are drawn
      from numpy.random.default_rng(seed), not from the JAX package's
      stream (the script's 29 x 5 chemical design is not in the repo; it
      falls back to random samples too).
  flagship_problem  utils/flagship.py's full-width workload (128 x 512 x
      256 rank 16, 128 x 1024 x 64 rank 20, 128 x 4096 rank 20, type 4,
      non-negative) with its options and init options, for N_STARTS starts.
  kl_problem  utils/kl_workload.py's KL workload (128 x 256 x 256 Poisson
      counts, rank 8, KL, non-negative, MaxInnerIters 5), for N_STARTS
      starts: every start's factor steps by L-BFGS-B.
  sparse_problem  utils/sparse_workload.py's sparse COO workload
      (9,994,175 nonzeros in 2048^3, rank 16, non-negative), for N_STARTS
      starts.
  script07_problem  example script 07's configuration at its widths
      (utils/kl_workload.script07_problem: KL on a 50 x 30 x 40 tensor and
      a 50 x 70 matrix coupled by type 0), with S07_KEYS, the init seeds of
      its card-against-CPU run.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, ProblemData, ProblemSpec)
from matlab_code_tpu_torch.utils import flagship, kl_workload, sparse_workload

N_STARTS = 20          # example_script15.m:113
S15 = 28               # samples (examples/script15_realdata.py)
NOISE = 0.03
# the init seeds in 0-63 of script07_problem(seed=S07_SEED) whose
# 3-iteration float64 fit moves by less than 1e-13 (relative) under a
# 1e-14 relative perturbation of its init; most seeds move by 1e-10 to
# 1e-3 there, their L-BFGS-B stop tests decided by rounding
# (tests/test_torch_nonfrob_fit.py)
S07_SEED = 2
S07_KEYS = (0, 16, 20, 63)


def script15_selectors():
    """The selector matrices H_p (6 x R_p) of example_script15.m:47-51."""
    H0 = np.vstack([np.eye(3), np.zeros((3, 3))])
    H3 = np.vstack([np.eye(5), np.zeros((1, 5))])
    T = np.hstack([np.eye(4), np.zeros((4, 1))])
    H6 = np.vstack([T, np.zeros((1, 5)), np.array([[0, 0, 0, 0, 1]])])
    return H0, H3, H6


def script15_spec() -> ProblemSpec:
    NN = ConstraintSpec("non-negativity")
    return ProblemSpec(
        mode_sizes=(S15, 60, 30, S15, 80, 16, S15, 120),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=1 / 3),
                  DatasetSpec(model="CP", modes=(3, 4, 5), rank=5,
                              weight=1 / 3),
                  DatasetSpec(model="CP", modes=(6, 7), rank=5, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN,) * 8)


def _unit(X: np.ndarray) -> np.ndarray:
    return X / np.linalg.norm(X)


def script15_problem(device="cuda", dtype=torch.float64, seed: int = 0):
    """(spec, data, options, init_options) at example script 15's widths:
    X_p built from Delta H_p and uniform factors, noise NOISE of the
    tensor's norm added, each dataset scaled to norm 1."""
    spec = script15_spec()
    H = script15_selectors()
    rng = np.random.default_rng(seed)
    Delta = rng.uniform(size=(S15, 6))
    f = {m: rng.uniform(size=(spec.mode_sizes[m],
                              spec.datasets[spec.which_p(m)].rank))
         for m in (1, 2, 4, 5, 7)}
    clean = (np.einsum("ir,jr,kr->ijk", Delta @ H[0], f[1], f[2]),
             np.einsum("ir,jr,kr->ijk", Delta @ H[1], f[4], f[5]),
             (Delta @ H[2]) @ f[7].T)
    objs = [_unit(_unit(X) + NOISE * _unit(rng.standard_normal(X.shape)))
            for X in clean]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    data = ProblemData(
        objects=tuple(t(X).contiguous() for X in objs),
        coupl_trafo=(t(H[0]), None, None, t(H[1]), None, None, t(H[2]), None),
        coupl_trafo2=(None,) * 8)
    options = AlgOptions(MaxOuterIters=1000, MaxInnerIters=5, AbsFuncTol=1e-4,
                         OuterRelTol=1e-10)
    init = InitOptions(distr=("rand",) * 8, normalize=True,
                       lambdas_init=((1,) * 3, (1,) * 5, (1,) * 5))
    return spec, data, options, init


def flagship_problem(device="cuda", dtype=torch.float32,
                     max_outer_iters: int = flagship.N_ITERS):
    """(spec, data, options, init_options) of utils/flagship.py, to fit
    with N_STARTS starts."""
    spec, data = flagship.build_problem(device, dtype)
    return (spec, data, flagship.flagship_options(max_outer_iters),
            flagship.flagship_init_options())


def kl_problem(device="cuda", dtype=torch.float32,
               shape=(kl_workload.I, kl_workload.J, kl_workload.K),
               rank: int = kl_workload.R):
    """(spec, data, options, init_options) of utils/kl_workload.py's KL
    workload (`shape` and `rank` cut it for a run on the CPU)."""
    spec, data, _, options = kl_workload.build_problem(
        device, dtype, shape=shape, rank=rank)
    return spec, data, options, InitOptions(
        distr=("rand",) * 3, normalize=True, lambdas_init=((1,) * rank,))


def sparse_problem(device="cuda", dtype=torch.float32,
                   D: int = sparse_workload.D, NNZ: int = sparse_workload.NNZ,
                   R: int = sparse_workload.R):
    """(spec, data, options, init_options) of utils/sparse_workload.py's
    sparse COO workload (D, NNZ and R cut it for a run on the CPU)."""
    spec, data = sparse_workload.build_problem(D, NNZ, R, device, dtype)
    return (spec, data, sparse_workload.sparse_options(),
            sparse_workload.sparse_init_options(R))


def script07_problem(device="cuda", dtype=torch.float64,
                     max_outer_iters: int = 3):
    """(spec, data, options, init_options) at example script 07's widths
    (utils/kl_workload.script07_problem with S07_SEED), its options over
    max_outer_iters iterations with AbsFuncTol = OuterRelTol = 0."""
    spec, data = kl_workload.script07_problem(device, dtype, seed=S07_SEED)
    return (spec, data, kl_workload.script07_options(
                max_outer_iters, AbsFuncTol=0.0, OuterRelTol=0.0),
            kl_workload.script07_init_options())
