"""The sparse COO CP workload, rebuilt for the port: bench_large.py's
`sparse_problem` (bench_large.py:141-180; the sizes bench_sparse_pallas.py
times), the reference's sptensor path.

One CP dataset with Frobenius loss and non-negativity on all three modes:
NNZ coordinates drawn uniformly in a D x D x D tensor, duplicates dropped,
uniform values, rank R.  The draws come from numpy.random.default_rng(0) in
bench_large's order; the duplicates are dropped (the rows of
np.unique(..., axis=0), in its order) and the tensor is assembled on the
target device.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, ProblemData, ProblemSpec,
    SparseTensor)

D, NNZ, R = 2048, 10_000_000, 16


def build_problem(D: int = D, NNZ: int = NNZ, R: int = R, device="cuda",
                  dtype=torch.float32):
    """(spec, data) of the workload, the COO tensor on `device` in
    `dtype` (indices int32)."""
    rng = np.random.default_rng(0)
    draws = torch.as_tensor(rng.integers(0, D, size=(NNZ, 3)).astype(np.int32),
                            device=device).long()
    # the sorted distinct rows, as np.unique(draws, axis=0) gives them: the
    # linearized coordinate orders rows lexicographically
    key = torch.unique((draws[:, 0] * D + draws[:, 1]) * D + draws[:, 2])
    idx = torch.stack([key // (D * D), key // D % D, key % D], 1)
    vals = rng.uniform(size=idx.shape[0])
    st = SparseTensor(idx.to(torch.int32),
                      torch.as_tensor(vals, dtype=dtype, device=device))
    data = ProblemData(objects=(st,), coupl_trafo=(None,) * 3,
                       coupl_trafo2=(None,) * 3)
    spec = ProblemSpec(
        mode_sizes=(D, D, D),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"),) * 3)
    return spec, data


def sparse_options(max_outer_iters: int = 10, **kw) -> AlgOptions:
    return AlgOptions(MaxOuterIters=max_outer_iters, MaxInnerIters=5, **kw)


def sparse_init_options(R: int = R) -> InitOptions:
    return InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
