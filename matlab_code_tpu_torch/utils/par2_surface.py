"""The PARAFAC2 surface: the PAR2 K=512 workload's widths (utils/
par2_workload.py: K = 512 slices of I = 256 rows, J = 256, rank 32,
non-negative A and C) under each Bk constraint the port runs on a kernel,
and coupled with a CP tensor, so that one fit of each runs the slice-wise
prox kernels (ops/prox_cuda.py: A batched, B batched, C) or the dense
MTTKRP kernel:

  unimodal   unimodality (non-negative) on Bk, switched on at outer
             iteration ITER_START with rho_Bk x RHO_BK, as script 9 does
             (iter_start_PAR2Bkconstraint 100 of its 2000 iterations,
             increase_factor_rhoBk 10; the surface runs 20)
  tv         TV regularization (TV_ETA) on Bk
  tparafac2  tPARAFAC2 (eta T_ETA) on Bk with ridge T_RIDGE on A and C,
             the data not normalised: script 11's settings
             (example_script11:77, :115-117)
  ragged     ragged slices, J_k drawn from 192..256, unimodality
             (non-negative) on Bk from the first iteration
  coupled    the PAR2 dataset beside a CP tensor I x CP_J x K/2: the CP
             sample mode and PAR2's A mode coupled by type 0, the CP third
             mode and PAR2's C mode by type 1 (H = I for the CP mode, every
             second row of C for PAR2's), as scripts 1 and 14 do; every
             mode non-negative but Bk; dataset weights 0.5

The ground truth is drawn on the host from numpy.random.default_rng(seed),
each Bk of the kind its constraint asks for (shifted Gaussian bumps,
piecewise-constant levels, a slow random walk over k, Gaussian); the data
are assembled on `device` and each dataset normalised to norm 1 (but
tparafac2's).  `K` cuts the number of slices (the CP tensor's third mode
with it) for a run on the CPU; the widths stay.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, Parafac2Tensor, ProblemData,
    ProblemSpec)

CONFIGS = ("unimodal", "tv", "tparafac2", "ragged", "coupled")
I, J, K, R = 256, 256, 512, 32
J_RAGGED = (192, 256)
CP_J = 128
ITER_START, RHO_BK = 10, 10.0
TV_ETA, T_ETA = 1e-3, 1000.0
T_RIDGE = (100.0, 0.0, 100.0)
N_ITERS = 20
NN = ConstraintSpec("non-negativity")


def slice_sizes(config: str, K: int = K, seed: int = 0) -> tuple:
    if config != "ragged":
        return (J,) * K
    rng = np.random.default_rng(seed + 100)
    return tuple(int(v) for v in rng.integers(J_RAGGED[0], J_RAGGED[1] + 1,
                                              size=K))


def surface_spec(config: str, K: int = K, seed: int = 0) -> ProblemSpec:
    if config not in CONFIGS:
        raise ValueError(f"the PARAFAC2 surface takes {CONFIGS}, got {config!r}")
    sizes = slice_sizes(config, K, seed)
    if config == "coupled":
        return ProblemSpec(
            mode_sizes=(I, CP_J, K // 2, I, sizes, K),
            datasets=(DatasetSpec("CP", (0, 1, 2), R, weight=0.5),
                      DatasetSpec("PAR2", (3, 4, 5), R, weight=0.5)),
            coupling=CouplingSpec((1, 0, 2, 1, 0, 2), (0, 1)),
            constraints=(NN, NN, NN, NN, None, NN))
    bk = {"unimodal": ConstraintSpec("unimodality", (True,)),
          "ragged": ConstraintSpec("unimodality", (True,)),
          "tv": ConstraintSpec("TV regularization", (TV_ETA,)),
          "tparafac2": ConstraintSpec("tPARAFAC2", (T_ETA,))}[config]
    return ProblemSpec(
        mode_sizes=(I, sizes, K),
        datasets=(DatasetSpec("PAR2", (0, 1, 2), R),),
        coupling=CouplingSpec((0, 0, 0), ()),
        constraints=(NN, bk, NN),
        ridge=T_RIDGE if config == "tparafac2" else None)


def _truth_B(config: str, sizes: tuple, rng) -> np.ndarray:
    K, Jmax = len(sizes), max(sizes)
    B = np.zeros((K, Jmax, R))
    if config in ("unimodal", "ragged"):
        for k, Jk in enumerate(sizes):
            x = np.linspace(-10.0, 10.0, Jk)[:, None]
            centre = (-8.0 + 16.0 * np.arange(R) / (R - 1)
                      + 2.0 * np.sin(2 * np.pi * k / K))[None, :]
            B[k, :Jk] = np.exp(-0.5 * ((x - centre) / 0.8) ** 2)
    elif config == "tv":
        levels = rng.standard_normal((R, 8))[None] \
            + 0.1 * rng.standard_normal((K, R, 8))
        seg = (np.arange(Jmax) * 8) // Jmax
        B[:] = levels[:, :, seg].transpose(0, 2, 1)
    elif config == "tparafac2":
        B[:] = rng.standard_normal((Jmax, R))[None] + 0.05 * np.cumsum(
            rng.standard_normal((K, Jmax, R)), axis=0)
    else:
        B[:] = rng.standard_normal((K, Jmax, R))
    return B


def build_problem(config: str, device="cuda", dtype=torch.float32,
                  K: int = K, seed: int = 0):
    """(spec, data) of one configuration of the surface."""
    spec = surface_spec(config, K, seed)
    sizes = slice_sizes(config, K, seed)
    rng = np.random.default_rng(seed)
    A = rng.uniform(size=(I, R))
    C = rng.uniform(0.5, 1.5, size=(K, R))
    B = _truth_B(config, sizes, rng)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    X = (t(A)[None] * t(C)[:, None, :]) @ t(B).transpose(1, 2)
    if config != "tparafac2":
        X = X / torch.linalg.vector_norm(X)
    X = X.contiguous()
    mask = torch.arange(max(sizes), device=device)[None, :] < torch.tensor(
        sizes, device=device)[:, None]
    par2 = Parafac2Tensor(X, mask)
    if config != "coupled":
        return spec, ProblemData(objects=(par2,), coupl_trafo=(None,) * 3,
                                 coupl_trafo2=(None,) * 3)
    Bcp = rng.uniform(size=(CP_J, R))
    Xcp = torch.einsum("ir,jr,kr->ijk", t(A), t(Bcp), t(C[0::2]))
    Xcp = (Xcp / torch.linalg.vector_norm(Xcp)).contiguous()
    H = np.zeros((K // 2, K))
    H[np.arange(K // 2), 2 * np.arange(K // 2)] = 1.0
    trafo = (None, None, t(np.eye(K // 2)), None, None, t(H))
    return spec, ProblemData(objects=(Xcp, par2), coupl_trafo=trafo,
                             coupl_trafo2=(None,) * 6)


def surface_options(config: str, n_iters: int = N_ITERS, **kw) -> AlgOptions:
    if config == "unimodal":
        kw = dict(iter_start_PAR2Bkconstraint=ITER_START,
                  increase_factor_rhoBk=RHO_BK, **kw)
    return AlgOptions(MaxOuterIters=n_iters, MaxInnerIters=5, **kw)


def surface_init_options(config: str) -> InitOptions:
    nb = 6 if config == "coupled" else 3
    ranks = ((1,) * R,) * (2 if config == "coupled" else 1)
    return InitOptions(distr=("rand",) * nb, normalize=True, lambdas_init=ranks)
