"""The CP surface workload: the flagship's three CP datasets
(bench.py:71-105, utils/flagship.py) under coupling type 1, 2, 3 or 5, with
a constraint or regularizer of another kind on every non-shared mode, so
that one fit runs the dense MTTKRP kernel and both sequential-prox kernels
(ops/prox_cuda.py).

  dataset 0  S0 x 512 x 256 tensor: unimodality (non-negative) on the 512
             mode, TV regularization (1e-3) on the 256 mode
  dataset 1  S x 1024 x 64 tensor: GL smoothness (1.0) on the 1024 mode,
             column-wise simplex (1.0) on the 64 mode
  dataset 2  S x 4096 matrix: l1 regularization (0.1) on the 4096 mode
  sample modes (0, 3, 6): non-negative, coupled by type ctype (S = 128):

  ctype 1  H_p C_p = Delta; S0 = 256 sampled at twice the rate, H_0 picks
           every second row (128 x 256), H_1 = H_2 = I; ranks 16, 16, 16
  ctype 2  C_p H_p = Delta; S0 = 128, H_p = randn(R_p, 16) + 2 [I; 0];
           ranks 16, 20, 20
  ctype 3  C_p = H_p Delta; S0 = 128, H_p = randn(128, 64); ranks 16, 16, 16
  ctype 5  H_p C_p = Delta H2_p; S0 = 256 with H_0 as for type 1, H_1 =
           H_2 = I, H2_0 = I_16, H2_1 = H2_2 = [I_12; 0]; Delta 128 x 16;
           ranks 16, 12, 12

The ground truth is drawn on the host from numpy.random.default_rng(seed)
(Delta uniform; each mode's factor of the kind its constraint asks for:
Gaussian bumps, piecewise-constant levels, smooth bumps, simplex columns,
sparse non-negative rows), and the data tensors are assembled on `device`,
each normalised to norm 1.  `scale` divides every mode size (not the
ranks) for tests on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.problem import (
    ConstraintSpec, CouplingSpec, DatasetSpec, ProblemData, ProblemSpec)

CTYPES = (1, 2, 3, 5)
S = 128
RANKS = {1: (16, 16, 16), 2: (16, 20, 20), 3: (16, 16, 16), 5: (16, 12, 12)}
RDELTA = 16          # columns of Delta (types 1, 2, 5); type 3: 16 too
D3 = 64              # rows of Delta for type 3
N_ITERS = 20


def mode_sizes(ctype: int, scale: int = 1) -> tuple:
    s = S // scale
    s0 = 2 * s if ctype in (1, 5) else s
    return (s0, 512 // scale, 256 // scale, s, 1024 // scale, 64 // scale,
            s, 4096 // scale)


def surface_spec(ctype: int, scale: int = 1) -> ProblemSpec:
    if ctype not in CTYPES:
        raise ValueError(f"the surface workload takes coupling types {CTYPES}")
    R0, R1, R2 = RANKS[ctype]
    NN = ConstraintSpec("non-negativity")
    return ProblemSpec(
        mode_sizes=mode_sizes(ctype, scale),
        datasets=(
            DatasetSpec(model="CP", modes=(0, 1, 2), rank=R0, weight=1 / 3),
            DatasetSpec(model="CP", modes=(3, 4, 5), rank=R1, weight=1 / 3),
            DatasetSpec(model="CP", modes=(6, 7), rank=R2, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0, 1, 0),
                              coupling_type=(ctype,)),
        constraints=(NN, ConstraintSpec("unimodality", (1,)),
                     ConstraintSpec("TV regularization", (1e-3,)),
                     NN, ConstraintSpec("GL smoothness", (1.0,)),
                     ConstraintSpec("simplex column-wise", (1.0,)),
                     NN, ConstraintSpec("l1 regularization", (0.1,))))


def _bumps(rng, n, R, width):
    t = np.arange(n)[:, None]
    mu = rng.uniform(0.1 * n, 0.9 * n, size=R)
    sd = width * n * rng.uniform(0.5, 1.5, size=R)
    return np.exp(-0.5 * ((t - mu) / sd) ** 2)


def _piecewise(rng, n, R, levels=5):
    A = np.zeros((n, R))
    for r in range(R):
        cuts = np.concatenate([[0], np.sort(rng.integers(1, max(n, 2), levels - 1)),
                               [n]])
        vals = rng.uniform(size=levels)
        for i in range(levels):
            A[cuts[i]:cuts[i + 1], r] = vals[i]
    return A


def _double_rate(Delta):
    """A factor at twice Delta's sampling rate whose even rows are Delta's
    and odd rows the mean of their neighbours (H_0 picks the even rows)."""
    nxt = np.concatenate([Delta[1:], Delta[-1:]])
    out = np.empty((2 * Delta.shape[0], Delta.shape[1]))
    out[0::2], out[1::2] = Delta, (Delta + nxt) / 2
    return out


def _truth(ctype: int, scale: int, seed: int):
    """(H, H2, sample-mode factors, other factors, delta_shapes) in float64."""
    rng = np.random.default_rng(seed)
    sizes = mode_sizes(ctype, scale)
    s = sizes[3]
    R0, R1, R2 = RANKS[ctype]
    H = [None] * 8
    H2 = [None] * 8
    delta_shapes = None
    if ctype in (1, 5):
        H[0] = np.zeros((s, 2 * s))
        H[0][np.arange(s), 2 * np.arange(s)] = 1.0
        H[3], H[6] = np.eye(s), np.eye(s)
        Delta = rng.uniform(size=(s, RDELTA))
        if ctype == 1:
            C = [_double_rate(Delta), Delta, Delta]
        else:
            H2[0] = np.eye(RDELTA)
            H2[3] = H2[6] = np.vstack([np.eye(R1), np.zeros((RDELTA - R1, R1))])
            C = [_double_rate(Delta), Delta @ H2[3], Delta @ H2[6]]
            delta_shapes = {1: (s, RDELTA)}
    elif ctype == 2:
        for m, R in ((0, R0), (3, R1), (6, R2)):
            H[m] = rng.standard_normal((R, RDELTA)) + 2 * np.eye(R, RDELTA)
        Delta = rng.uniform(size=(s, RDELTA))
        C = [Delta @ np.linalg.pinv(H[m]) for m in (0, 3, 6)]
    else:
        d3 = D3 // scale
        for m in (0, 3, 6):
            H[m] = rng.standard_normal((s, d3))
        Delta = rng.uniform(size=(d3, RDELTA))
        C = [H[m] @ Delta for m in (0, 3, 6)]
    other = {1: _bumps(rng, sizes[1], R0, 0.08),
             2: _piecewise(rng, sizes[2], R0),
             4: _bumps(rng, sizes[4], R1, 0.15),
             5: rng.uniform(size=(sizes[5], R1)),
             7: rng.uniform(size=(sizes[7], R2))
             * (rng.uniform(size=(sizes[7], R2)) < 0.1)}
    other[5] /= other[5].sum(axis=0, keepdims=True)
    return H, H2, C, other, delta_shapes


def build_problem(ctype: int, device="cuda", dtype=torch.float32, scale=1,
                  seed=0):
    """(spec, data, delta_shapes) of the surface workload under coupling
    type ctype, the data assembled on `device` in `dtype`; delta_shapes is
    init_coupled's argument (the Delta shape of type 5, else None)."""
    spec = surface_spec(ctype, scale)
    H, H2, C, f, delta_shapes = _truth(ctype, scale, seed)
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=dtype,
                                                         device=device)
    C = [t(c) for c in C]
    f = {m: t(a) for m, a in f.items()}
    X0 = torch.einsum("ir,jr,kr->ijk", C[0], f[1], f[2])
    X1 = torch.einsum("ir,jr,kr->ijk", C[1], f[4], f[5])
    X2 = C[2] @ f[7].T
    # einsum may return a permuted view; the MTTKRP kernel reads X row-major
    objects = tuple((X / torch.linalg.norm(X)).contiguous()
                    for X in (X0, X1, X2))
    data = ProblemData(objects=objects, coupl_trafo=tuple(map(t, H)),
                       coupl_trafo2=tuple(map(t, H2)))
    return spec, data, delta_shapes


def surface_options(max_outer_iters: int = N_ITERS, **kw) -> AlgOptions:
    return AlgOptions(MaxOuterIters=max_outer_iters, MaxInnerIters=5, **kw)


def surface_init_options(ctype: int) -> InitOptions:
    return InitOptions(distr=("rand",) * 8, normalize=True,
                       lambdas_init=tuple((1,) * R for R in RANKS[ctype]))
