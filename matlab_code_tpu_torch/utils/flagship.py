"""The flagship workload, rebuilt for the port: the script-15-class
EEM/NMR/LCMS fusion that bench.py times (bench.py:29-105), with the same
sizes, ranks, weights, selectors, ground truth and normalisation.

Three CP datasets with Frobenius loss share the sample mode (modes 0, 3, 6)
through a type-4 selector coupling C_p = Delta H_p (H_p of size RTOT x R_p);
every mode is non-negative:
  EEM-like   S x 512 x 256 tensor, rank 16
  NMR-like   S x 1024 x 64 tensor, rank 20
  LCMS-like  S x 4096 matrix,      rank 20
The small ground-truth factors are drawn on the host from
numpy.random.default_rng(0) exactly as bench.py draws them; the data
tensors are assembled on the target device.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, ProblemData, ProblemSpec)

S = 128
RTOT = 24
R1, R2, R3 = 16, 20, 20
N_ITERS = 300       # bench.py's timed outer iterations
MODE_SIZES = (S, 512, 256, S, 1024, 64, S, 4096)


def _selectors(rng):
    """Column-selector H_i (RTOT, R_i) like example_script15:47-51."""
    H1 = np.zeros((RTOT, R1))
    H1[np.arange(R1), np.arange(R1)] = 1.0
    H2 = np.zeros((RTOT, R2))
    H2[np.arange(R2), np.arange(R2)] = 1.0
    H3 = np.zeros((RTOT, R3))
    cols = rng.permutation(RTOT)[:R3]
    H3[cols, np.arange(R3)] = 1.0
    return H1, H2, H3


def _flagship_truth(dtype=np.float64):
    """Ground-truth selectors, Delta and the factors of the non-shared modes,
    in bench.py's draw order."""
    rng = np.random.default_rng(0)
    H1, H2, H3 = _selectors(rng)
    Delta = rng.uniform(size=(S, RTOT)).astype(dtype)
    sizes = {1: 512, 2: 256, 4: 1024, 5: 64, 7: 4096}
    ranks = {1: R1, 2: R1, 4: R2, 5: R2, 7: R3}
    f = {m: rng.uniform(size=(sizes[m], ranks[m])).astype(dtype)
         for m in (1, 2, 4, 5, 7)}
    return (H1.astype(dtype), H2.astype(dtype), H3.astype(dtype)), Delta, f


def flagship_spec() -> ProblemSpec:
    NN = ConstraintSpec("non-negativity")
    return ProblemSpec(
        mode_sizes=MODE_SIZES,
        datasets=(
            DatasetSpec(model="CP", modes=(0, 1, 2), rank=R1, weight=1 / 3),
            DatasetSpec(model="CP", modes=(3, 4, 5), rank=R2, weight=1 / 3),
            DatasetSpec(model="CP", modes=(6, 7), rank=R3, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN,) * 8)


def build_problem(device="cuda", dtype=torch.float32):
    """(spec, data) of the flagship, the data assembled on `device` in
    `dtype`: X_p = ktensor(Delta H_p, ...) / ||.||_F."""
    (H1, H2, H3), Delta, f = _flagship_truth(
        np.float64 if dtype == torch.float64 else np.float32)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Delta, H1, H2, H3 = map(t, (Delta, H1, H2, H3))
    f = {m: t(a) for m, a in f.items()}
    X1 = torch.einsum("ir,jr,kr->ijk", Delta @ H1, f[1], f[2])
    X2 = torch.einsum("ir,jr,kr->ijk", Delta @ H2, f[4], f[5])
    X3 = (Delta @ H3) @ f[7].T
    # einsum may return a permuted view; the MTTKRP kernel reads X row-major
    objects = tuple((X / torch.linalg.norm(X)).contiguous()
                    for X in (X1, X2, X3))
    data = ProblemData(objects=objects,
                       coupl_trafo=(H1, None, None, H2, None, None, H3, None),
                       coupl_trafo2=(None,) * 8)
    return flagship_spec(), data


def flagship_options(max_outer_iters: int = N_ITERS, **kw) -> AlgOptions:
    return AlgOptions(MaxOuterIters=max_outer_iters, MaxInnerIters=5, **kw)


def flagship_init_options() -> InitOptions:
    return InitOptions(distr=("rand",) * 8, normalize=True,
                       lambdas_init=((1,) * R1, (1,) * R2, (1,) * R3))
