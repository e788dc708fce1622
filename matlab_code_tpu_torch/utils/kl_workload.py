"""The production-scale KL workload, rebuilt for the port without jax:
bench_large.py's `kl_problem` (bench_large.py:116-139), the L-BFGS-B
factor subproblems of the reference's KL path, where every evaluation
materializes the model tensor (cmtf_fun_AOADMM.m:1368-1372).

One CP dataset of 128 x 256 x 256 Poisson counts (33.5 MB in float32),
rank 8, KL loss, non-negativity on every mode; MaxInnerIters 5 and the
default LbfgsbOptions.  The counts are drawn on the host from
numpy.random.default_rng(seed) in bench_large's order (three uniform
factors in float32, then rng.poisson(20 M)); the init is drawn with the
port's init_coupled from a generator seeded with 1, bench_large's key.

Beside it, example script 07's configuration at its widths
(script07_problem), which the card holds to the CPU in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.options import AlgOptions, InitOptions, LbfgsbOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, ProblemData, ProblemSpec)

I, J, K, R = 128, 256, 256, 8


def kl_options(n_iters: int = 10, **kw) -> AlgOptions:
    return AlgOptions(MaxOuterIters=n_iters, MaxInnerIters=5, **kw)


def build_problem(device="cuda", dtype=torch.float32, seed: int = 0,
                  shape=(I, J, K), rank: int = R):
    """(spec, data, init state, options) of the workload on `device` in
    `dtype`; `shape` and `rank` cut it for a run on the CPU."""
    spec = ProblemSpec(
        mode_sizes=tuple(shape),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=rank,
                              loss="KL"),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"),) * 3)
    rng = np.random.default_rng(seed)
    facs = [rng.uniform(size=(s, rank)).astype(np.float32) for s in shape]
    lam = rng.poisson(20.0 * np.einsum("ir,jr,kr->ijk", *facs))
    data = ProblemData(objects=(torch.tensor(lam, dtype=dtype, device=device),),
                       coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * rank,))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    state = init_coupled(spec, data, init, generator=gen)
    return spec, data, state, kl_options()


def script07_spec() -> ProblemSpec:
    """Example script 07 (examples/script07_matrix_cp_kl.py,
    example_script7_matrix_CP_KLdivergence.m): a 50 x 30 x 40 tensor and a
    50 x 70 matrix, rank 3, KL loss, weights 0.5, modes 0 and 3 coupled by
    type 0, no constraints."""
    return ProblemSpec(
        mode_sizes=(50, 30, 40, 50, 70),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5,
                              loss="KL"),
                  DatasetSpec(model="CP", modes=(3, 4), rank=3, weight=0.5,
                              loss="KL")),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=(None,) * 5)


def script07_options(n_iters: int, **kw) -> AlgOptions:
    """Script 07's options (example_script7:64-69, 95-107) with n_iters
    outer iterations; kw overrides."""
    opts = dict(MaxOuterIters=n_iters, MaxInnerIters=5, AbsFuncTol=1e-4,
                OuterRelTol=1e-6, innerRelPrTol_coupl=1e-3,
                innerRelPrTol_constr=1e-3, innerRelDualTol_coupl=1e-3,
                innerRelDualTol_constr=1e-3,
                lbfgsb=LbfgsbOptions(m=5, maxIts=100, pgtol=1e-4))
    opts.update(kw)
    return AlgOptions(**opts)


def script07_problem(device="cuda", dtype=torch.float64, seed: int = 0):
    """(spec, data) at script 07's widths: noise-free data of factors drawn
    from U(0.1, 1.1) with numpy.random.default_rng(seed), the shared mode-0
    factor in both datasets.  (Script 07's own Gamma(1, 1) factors put the
    fit where rounding alone decides its L-BFGS-B stop tests, so no two
    summation orders agree on it; tests/test_torch_nonfrob_fit.py.)"""
    rng = np.random.default_rng(seed)
    A, B, C, E = (rng.uniform(0.1, 1.1, size=(n, 3)) for n in (50, 30, 40, 70))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    data = ProblemData(objects=(t(np.einsum("ir,jr,kr->ijk", A, B, C)),
                                t(A @ E.T)),
                       coupl_trafo=(None,) * 5, coupl_trafo2=(None,) * 5)
    return script07_spec(), data


def script07_init_options() -> InitOptions:
    return InitOptions(distr=("rand",) * 5, normalize=True,
                       lambdas_init=((1, 1, 1), (1, 1, 1)))
