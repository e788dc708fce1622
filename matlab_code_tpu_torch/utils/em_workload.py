"""The full-width EM (missing data) configurations: two workloads of the
repo with example script 12's 20 % of the entries missing at random
(examples/script12_cp_par2_em.py:28), the missing entries set to 0 as
script 12 sets them (example_script12.m:143-147), and imputed by the fit.

  (a) build_flagship: utils/flagship.py's three datasets (128x512x256 R 16,
      128x1024x64 R 20, 128x4096 R 20, type-4 selector coupling, every mode
      non-negative) at the same sizes, ranks, coupling and constraints;
  (b) build_par2: utils/par2_workload.py's 512 slices of 256 x 256, rank
      32, non-negative A and C.

Each dataset's mask (True = observed) is drawn on the host from
numpy.random.default_rng(seed), one uniform draw an entry in C order, a
dataset after the other, as examples/common.add_missing draws it; a
PARAFAC2 dataset's padded columns count as observed.  The masks and the
data are assembled on `device`.

Beside them, the small problems that chip_smoke.py and the card tests fit
on the card and on the CPU in float64: script12_problem, example script
12's widths (a 20x30x40 CP tensor and 30 PARAFAC2 slices of 20 x 25, rank
3, coupled by type 0, 20 % missing; its data drawn from numpy, not from
the reference's stream), and pp_problem, tests/test_pairwise.py's
20x30x40 rank-3 CP problem, dense or as a COO tensor, for the
pairwise-perturbation MTTKRP.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, Parafac2Tensor, ProblemData,
    ProblemSpec, SparseTensor)
from matlab_code_tpu_torch.utils import flagship, par2_workload

MISS_FRACTION = 0.2


def add_missing(data: ProblemData, fraction: float = MISS_FRACTION,
                seed: int = 0) -> ProblemData:
    """`data` with a `fraction` of every dataset's entries missing at random
    (mask True = observed) and those entries set to 0."""
    rng = np.random.default_rng(seed)
    objects, miss = [], []
    for X in data.objects:
        dense = X.slices if isinstance(X, Parafac2Tensor) else X
        mask = torch.as_tensor(rng.uniform(size=tuple(dense.shape)) > fraction,
                               device=dense.device)
        if isinstance(X, Parafac2Tensor):
            mask = mask | ~X.mask[:, None, :]
        new = torch.where(mask, dense, torch.zeros((), dtype=dense.dtype,
                                                   device=dense.device))
        objects.append(Parafac2Tensor(new, X.mask)
                       if isinstance(X, Parafac2Tensor) else new)
        miss.append(mask)
    return dataclasses.replace(data, objects=tuple(objects), miss=tuple(miss))


def build_flagship(device="cuda", dtype=torch.float32, seed: int = 0):
    """(spec, data): the flagship with 20 % of every dataset missing."""
    spec, data = flagship.build_problem(device, dtype)
    return spec, add_missing(data, seed=seed)


def build_par2(device="cuda", dtype=torch.float32, K: int = par2_workload.K,
               seed: int = 0):
    """(spec, data): the PAR2 workload (K slices) with 20 % missing."""
    spec, data = par2_workload.build_problem(device, dtype, K)
    return spec, add_missing(data, seed=seed)


def _unit(X: np.ndarray) -> np.ndarray:
    return X / np.linalg.norm(X)


def script12_problem(device="cuda", dtype=torch.float64, seed: int = 0):
    """(spec, data, options, init_options) at example script 12's widths
    (examples/script12_cp_par2_em.py build()): CP 20x30x40 rank 3 and
    PARAFAC2 20 x 25 x 30 slices rank 3, weights 0.5, the CP sample mode
    and PARAFAC2's A mode coupled by type 0, no constraints, noise 0.05,
    each dataset of norm 1, 20 % of both missing."""
    K, J, R = 30, 25, 3
    spec = ProblemSpec(
        mode_sizes=(20, 30, 40, 20, (J,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=R,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(None,) * 6)
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((20, R))
    Xc = np.einsum("ir,jr,kr->ijk", A, rng.standard_normal((30, R)),
                   rng.standard_normal((40, R)))
    Ck = rng.uniform(size=(K, R)) + 0.1
    Xp = np.einsum("ir,kr,kjr->kij", A, Ck, rng.standard_normal((K, J, R)))
    noisy = [_unit(_unit(X) + 0.05 * _unit(rng.standard_normal(X.shape)))
             for X in (Xc, Xp)]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    data = ProblemData(
        objects=(t(noisy[0]), Parafac2Tensor(t(noisy[1]), torch.ones(
            (K, J), dtype=torch.bool, device=device))),
        coupl_trafo=(None,) * 6, coupl_trafo2=(None,) * 6)
    options = AlgOptions(MaxOuterIters=4000, MaxInnerIters=5, AbsFuncTol=1e-7,
                         OuterRelTol=1e-8)
    init = InitOptions(distr=("randn",) * 5 + ("rand+0.1",), normalize=True,
                       lambdas_init=((1,) * R, (1,) * R))
    return spec, add_missing(data, seed=seed + 1), options, init


def pp_problem(layout="dense", device="cuda", dtype=torch.float64,
               seed: int = 0):
    """(spec, data, init_options) of tests/test_pairwise.py's problem: a
    20x30x40 rank-3 CP tensor (mode 0 non-negative, U(0, 1); modes 1 and 2
    Gaussian), of norm 1, with noise 0.02 when dense; the "sparse" layout
    is the noise-free tensor with 40 % of its entries zeroed, as a COO
    tensor."""
    shape, R = (20, 30, 40), 3
    rng = np.random.default_rng(seed)
    X = _unit(np.einsum("ir,jr,kr->ijk", rng.uniform(size=(shape[0], R)),
                        rng.standard_normal((shape[1], R)),
                        rng.standard_normal((shape[2], R))))
    noise = rng.standard_normal(shape)
    if layout == "dense":
        obj = torch.as_tensor(_unit(X + 0.02 * _unit(noise)), dtype=dtype,
                              device=device)
    else:
        X[rng.uniform(size=shape) < 0.4] = 0.0
        obj = SparseTensor.from_dense(torch.as_tensor(X, dtype=dtype,
                                                      device=device))
    spec = ProblemSpec(
        mode_sizes=shape,
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None, None))
    data = ProblemData(objects=(obj,), coupl_trafo=(None,) * 3,
                       coupl_trafo2=(None,) * 3)
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1,) * R,))
    return spec, data, init
