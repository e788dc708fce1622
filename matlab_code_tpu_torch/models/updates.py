"""Per-mode precompute for the AO sweep: MTTKRPs, Gram-Hadamards, the rho
heuristic and the normal-equation matrices (counterpart of the CP part of
matlab_code_tpu/models/updates.py, cmtf_fun_AOADMM.m:92-127).  PARAFAC2
precomputes come with slice 4."""
from __future__ import annotations

from typing import NamedTuple

import torch

from matlab_code_tpu_torch.ops.tensor import (
    gram, hadamard_grams, mttkrp, mttkrp_sparse)
from matlab_code_tpu_torch.problem import ProblemSpec, ProblemData, SparseTensor


class ModePre(NamedTuple):
    """Precomputed quantities for one mode's update."""
    A: torch.Tensor | None        # RHS (I, R)
    B: torch.Tensor | None        # normal matrix before coupling/constraint terms
    rho: torch.Tensor | None      # scalar
    last_mttkrp: torch.Tensor | None
    last_had: torch.Tensor | None


def _eye(R: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(R, dtype=like.dtype, device=like.device)


def _ridge_eye(spec: ProblemSpec, m: int, R: int, like: torch.Tensor
               ) -> torch.Tensor | None:
    if spec.ridge is not None and spec.ridge[m]:
        return spec.ridge[m] * _eye(R, like)
    return None


def cp_mode_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                       p: int, m: int, options,
                       partials: dict | None = None) -> ModePre:
    """CP / matrix mode precompute (cmtf_fun_AOADMM.m:96-127).

    partials: optional per-sweep dimension-tree cache (options.
    cp_dimension_tree).  For 3-way tensors T1 = X x_0 A is shared by the
    mode-1 and mode-2 MTTKRPs; it is reused only while the mode-0 factor is
    the same tensor object (factors are never updated in place)."""
    ds = spec.datasets[p]
    X = data.objects[p]
    w = ds.weight
    R = ds.rank
    local = ds.modes.index(m)
    if isinstance(X, SparseTensor):
        # before the dimension tree: a sparse dataset never touches partials
        A = w * mttkrp_sparse(X.indices, X.values,
                              [state.fac[j] for j in ds.modes], local,
                              spec.mode_sizes[m],
                              plan=None if X.plans is None else X.plans[local])
        C = hadamard_grams([grams[j] for j in ds.modes if j != m])
    elif X.dim() == 3 and local > 0 and partials is not None \
            and options.cp_dimension_tree and R <= X.shape[0]:
        A0 = state.fac[ds.modes[0]]
        hit = partials.get(p)
        if hit is None or hit[0] is not A0:
            T1 = torch.einsum("ijk,ir->jkr", X, A0)
            partials[p] = (A0, T1)
        else:
            T1 = hit[1]
        if local == 1:
            A = w * torch.einsum("jkr,kr->jr", T1, state.fac[ds.modes[2]])
        else:
            A = w * torch.einsum("jkr,jr->kr", T1, state.fac[ds.modes[1]])
        C = hadamard_grams([grams[j] for j in ds.modes if j != m])
    elif X.dim() >= 3:
        A = w * mttkrp(X, [state.fac[j] for j in ds.modes], local)
        C = hadamard_grams([grams[j] for j in ds.modes if j != m])
    else:
        other = ds.modes[1 - local]
        if local == 0:
            A = w * (X @ state.fac[other])
        else:
            A = w * (X.T @ state.fac[other])
        C = grams[other]
    rho = torch.trace(C) / R
    B = w * C
    last_mttkrp = A / w
    last_had = C
    re = _ridge_eye(spec, m, R, A)
    if re is not None:
        B = B + re
    if options.bsum:
        A = A + options.bsum_weight / 2.0 * state.fac[m]
        B = B + options.bsum_weight / 2.0 * _eye(R, A)
    return ModePre(A=A, B=B, rho=rho, last_mttkrp=last_mttkrp, last_had=last_had)


def refresh_gram(spec: ProblemSpec, state, grams: tuple, m: int) -> tuple:
    """G_transp_G refresh after a CP mode update (cmtf_fun_AOADMM.m:148,396)."""
    return grams[:m] + (gram(state.fac[m]),) + grams[m + 1:]
