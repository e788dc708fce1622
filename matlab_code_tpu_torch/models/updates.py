"""Per-mode precompute for the AO sweep: MTTKRPs, Gram-Hadamards, the rho
heuristic and the normal-equation matrices (counterpart of
matlab_code_tpu/models/updates.py, cmtf_fun_AOADMM.m:92-251).  The
PARAFAC2 per-slice loops are batched over the stacked (K, ., .) arrays;
padded (ragged) rows and columns are zero and drop out of every sum."""
from __future__ import annotations

from typing import NamedTuple

import torch

from matlab_code_tpu_torch.ops.tensor import (
    gram, hadamard_grams, mttkrp, mttkrp_sparse)
from matlab_code_tpu_torch.problem import ProblemSpec, ProblemData, SparseTensor


class ModePre(NamedTuple):
    """Precomputed quantities for one mode's update."""
    A: torch.Tensor | None        # RHS (I,R) | (K,R) par2C
    B: torch.Tensor | None        # normal matrix before coupling/constraint terms
    rho: torch.Tensor | None      # scalar, or (K,) for a par2C mode
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
                       partials: dict | None = None,
                       mttkrp_impl=None) -> ModePre:
    """CP / matrix mode precompute (cmtf_fun_AOADMM.m:96-127).

    partials: optional per-sweep dimension-tree cache (options.
    cp_dimension_tree).  For 3-way tensors T1 = X x_0 A is shared by the
    mode-1 and mode-2 MTTKRPs; it is reused only while the mode-0 factor is
    the same tensor object (factors are never updated in place).

    mttkrp_impl: optional MTTKRP fn(X, factors) of this (dataset, mode)
    that replaces the dispatch below for sparse and >= 3-way data (the
    pairwise-perturbation MTTKRP, models/pairwise.pp_mttkrp)."""
    ds = spec.datasets[p]
    X = data.objects[p]
    w = ds.weight
    R = ds.rank
    local = ds.modes.index(m)
    if mttkrp_impl is not None and (isinstance(X, SparseTensor)
                                    or X.dim() >= 3):
        A = w * mttkrp_impl(X, tuple(state.fac[j] for j in ds.modes))
        C = hadamard_grams([grams[j] for j in ds.modes if j != m])
    elif isinstance(X, SparseTensor):
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


def par2_gram_Bk(facB: torch.Tensor) -> torch.Tensor:
    """(K, Jmax, R) -> per-slice Grams (K, R, R)."""
    return facB.transpose(1, 2) @ facB


def _par2_ridge_bsum(spec, state, m, R, A, B, options):
    re = _ridge_eye(spec, m, R, A)
    if re is not None:
        B = B + re
    if options.bsum:
        A = A + options.bsum_weight / 2.0 * state.fac[m]
        B = B + options.bsum_weight / 2.0 * _eye(R, A)
    return A, B


def par2A_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                     p: int, m: int, options) -> ModePre:
    """First PARAFAC2 mode: A = sum_k X_k B_k diag(c_k), C = sum_k diag(c_k)
    B_k^T B_k diag(c_k) (cmtf_fun_AOADMM.m:159-178)."""
    ds = spec.datasets[p]
    X = data.objects[p]
    mB, mC = ds.modes[1], ds.modes[2]
    R = ds.rank
    facB, facC = state.fac[mB], state.fac[mC]
    A0 = torch.sum((X.slices @ facB) * facC[:, None, :], dim=0)
    C = torch.einsum("kr,krs,ks->rs", facC, grams[mB], facC)
    A, B = _par2_ridge_bsum(spec, state, m, R, ds.weight * A0, ds.weight * C,
                            options)
    return ModePre(A=A, B=B, rho=torch.trace(C) / R, last_mttkrp=A0,
                   last_had=C)


def _par2_W(spec, data, state, p, partials):
    """The shared PARAFAC2 partial W_k = X_k^T A (K, Jmax, R) of the Bk and
    C precomputes, reused only while the A factor is the same tensor object
    (factors are never updated in place), so a stale A is never reused."""
    facA = state.fac[spec.datasets[p].modes[0]]
    key = ("par2W", p)
    if partials is not None:
        hit = partials.get(key)
        if hit is not None and hit[0] is facA:
            return hit[1]
    W = (facA.T @ data.objects[p].slices).transpose(1, 2)
    if partials is not None:
        partials[key] = (facA, W)
    return W


def par2B_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                     p: int, m: int, options, constraint_active: bool,
                     partials: dict | None = None):
    """Second PARAFAC2 mode, batched over slices (cmtf_fun_AOADMM.m:191-213).
    Returns (A (K,Jmax,R), B (K,R,R) the assembled normal matrix with the
    always-on internal-coupling rho_k/2 I and, while the constraint is
    active, another rho_k/2 I (:209-211), rho (K,))."""
    ds = spec.datasets[p]
    mA, mC = ds.modes[0], ds.modes[2]
    R = ds.rank
    facC = state.fac[mC]
    W = _par2_W(spec, data, state, p, partials)
    A = ds.weight * (W * facC[:, None, :])
    C = facC[:, :, None] * grams[mA][None] * facC[:, None, :]
    rho = torch.diagonal(C, dim1=1, dim2=2).sum(-1) / R
    if options.increase_factor_rhoBk is not None:
        rho = options.increase_factor_rhoBk * rho
    eye = _eye(R, A)
    B = ds.weight * C + 0.5 * rho[:, None, None] * eye
    A, B = _par2_ridge_bsum(spec, state, m, R, A, B, options)
    if constraint_active:
        B = B + 0.5 * rho[:, None, None] * eye
    return A, B, rho


def par2C_precompute(spec: ProblemSpec, data: ProblemData, state, grams,
                     p: int, m: int, options,
                     partials: dict | None = None) -> ModePre:
    """Third PARAFAC2 mode, row-wise batched (cmtf_fun_AOADMM.m:219-233):
    A (K, R) = w * colsum(W_k .* B_k), B (K, R, R) = w * GramA .* GramB_k,
    rho (K,)."""
    ds = spec.datasets[p]
    mA, mB = ds.modes[0], ds.modes[1]
    R = ds.rank
    W = _par2_W(spec, data, state, p, partials)
    A = ds.weight * torch.sum(W * state.fac[mB], dim=1)
    C = grams[mA][None, :, :] * grams[mB]
    rho = torch.diagonal(C, dim1=1, dim2=2).sum(-1) / R
    A, B = _par2_ridge_bsum(spec, state, m, R, A, ds.weight * C, options)
    return ModePre(A=A, B=B, rho=rho, last_mttkrp=None, last_had=None)


def mode_gram(spec: ProblemSpec, state, m: int) -> torch.Tensor:
    """Mode m's Gram: per-slice Grams (K, R, R) for a PARAFAC2 Bk mode."""
    if spec.mode_role(m) == "par2_B":
        return par2_gram_Bk(state.fac[m])
    return gram(state.fac[m])


def refresh_gram(spec: ProblemSpec, state, grams: tuple, m: int) -> tuple:
    """G_transp_G refresh after a mode update (cmtf_fun_AOADMM.m:148, 190,
    216, 396)."""
    return grams[:m] + (mode_gram(spec, state, m),) + grams[m + 1:]


def nonfrob_rho(colnorms, m: int) -> torch.Tensor:
    """rho of a non-Frobenius mode: the sum of the squared column norms of
    every OTHER mode (cmtf_fun_AOADMM.m:129), the zero entries of Frobenius
    modes included.  colnorms: one 0-d tensor a mode."""
    return torch.sum(torch.stack(list(colnorms))) - colnorms[m]


def refresh_colnorm_init(state, m: int) -> torch.Tensor:
    """Initial sum of squared column norms (cmtf_fun_AOADMM.m:77-80)."""
    return torch.sum(state.fac[m] ** 2)


def refresh_colnorm_update(state, m: int) -> torch.Tensor:
    """The refresh after an update.  The reference overwrites instead of
    accumulating inside its loop over r (cmtf_fun_AOADMM.m:151-153,
    399-401), so the refreshed value is the squared norm of the LAST column
    only; kept for the trajectories' sake."""
    return torch.sum(state.fac[m][:, -1] ** 2)
