"""The PARAFAC2 K=512 workload of bench.py:235-263 and bench_large.py:89-110
(ADMM_B_Parafac2's K-batched sweep at the scale BASELINE.md tracks),
without jax: one regular PARAFAC2 dataset of K = 512 slices of 256 x 256,
rank 32, non-negativity on A and C, Bk unconstrained, MaxInnerIters 5.

The ground truth is drawn on the host from numpy.random.default_rng(seed)
in bench.py's order (A uniform (I, R), C uniform(0.5, 1.5) (K, R), B
standard normal (K, J, R)); the slices X_k = A diag(c_k) B_k^T (134 MB in
float32) are assembled on `device`.  `K` cuts the number of slices for a
run on the CPU; the widths stay.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, Parafac2Tensor, ProblemData,
    ProblemSpec)

I, J, K, R = 256, 256, 512, 32
N_ITERS = 100


def par2_spec(K: int = K) -> ProblemSpec:
    NN = ConstraintSpec("non-negativity")
    return ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, NN))


def build_problem(device="cuda", dtype=torch.float32, K: int = K, seed: int = 0):
    """(spec, data): bench.py's PARAFAC2 problem with K slices."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(size=(I, R))
    C = rng.uniform(0.5, 1.5, size=(K, R))
    B = rng.standard_normal((K, J, R))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    X = (t(A)[None] * t(C)[:, None, :]) @ t(B).transpose(1, 2)
    data = ProblemData(
        objects=(Parafac2Tensor(X.contiguous(), torch.ones(
            (K, J), dtype=torch.bool, device=device)),),
        coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    return par2_spec(K), data


def par2_options(n_iters: int = N_ITERS, **kw) -> AlgOptions:
    return AlgOptions(MaxOuterIters=n_iters, MaxInnerIters=5, **kw)


def par2_init_options() -> InitOptions:
    return InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
