"""Tensor operations: MTTKRP (dense and sparse COO), Khatri-Rao, ktensor
reconstruction, Grams (counterpart of matlab_code_tpu/ops/tensor.py).

mttkrp sends every 3-way CUDA tensor to the hand-written kernel
(ops/mttkrp_cuda.mttkrp3), which takes float16, bfloat16, float32 and
float64 and raises on any other dtype; a CPU tensor and any other order
take the plain einsum.  mttkrp_sparse sends COO data on a CUDA card to the
hand-written sparse kernel (ops/sparse_cuda.mttkrp_sparse_cuda) and COO
data on the CPU to its plain version; AlgOptions.sparse_mttkrp chooses
nothing here.  On fit_multistart's start axis (ops/lanes.py) both are
custom operators whose batching rules lay the starts' factors side by
side, so one call serves every start.
"""
from __future__ import annotations

import functools
import string

import torch

from matlab_code_tpu_torch.ops.lanes import on_start_axis, to_front
from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
from matlab_code_tpu_torch.ops.sparse_cuda import (
    SparsePlan, mttkrp_sparse_cuda, mttkrp_sparse_reference, plan_fields,
    plan_from_fields, start_groups)

_LETTERS = string.ascii_lowercase


def takes_kernel(X: torch.Tensor) -> bool:
    """True where mttkrp sends a dense X to the hand-written kernel: every
    3-way CUDA tensor, whatever its dtype (the kernel raises on a dtype it
    does not take)."""
    return X.dim() == 3 and X.device.type == "cuda"


def mttkrp(X: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """Matricized-tensor times Khatri-Rao product for dense X:
    unfold(X, mode) @ khatri_rao(factors except mode), shape
    (X.shape[mode], R) (Tensor Toolbox `mttkrp`, cmtf_fun_AOADMM.m:97), in
    the dtype torch.einsum would give (as the JAX package's mttkrp).

    Which path runs is decided from X alone, before any launch: a 3-way
    CUDA tensor launches the kernel (takes_kernel), which raises on a
    non-contiguous X (fit makes its datasets contiguous once) and on a
    dtype other than float16, bfloat16, float32 and float64.  The kernel
    accumulates and returns promote(X.dtype, float32), as the Pallas kernel
    does; its result is cast to the einsum's dtype once, at the end (a
    no-op in float32 and float64).  Every other X takes torch.einsum."""
    n = X.dim()
    if len(factors) != n:
        raise ValueError(f"mttkrp: {len(factors)} factors for a {n}-way tensor")
    if n == 3 and on_start_axis(X, *factors):
        return _mttkrp_starts(X, list(factors), mode)
    if takes_kernel(X):
        operands = [X] + [factors[i] for i in range(n) if i != mode]
        dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
        return mttkrp3(X, factors, mode).to(dt)
    return mttkrp_einsum(X, factors, mode)


def mttkrp_einsum(X: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """The plain MTTKRP: one torch.einsum on any device."""
    n = X.dim()
    operands = [X] + [factors[i] for i in range(n) if i != mode]
    tensor_sub = _LETTERS[:n]
    factor_subs = [f"{_LETTERS[i]}z" for i in range(n) if i != mode]
    eq = tensor_sub + "," + ",".join(factor_subs) + "->" + _LETTERS[mode] + "z"
    return torch.einsum(eq, *operands)


def mttkrp_columns(X: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """The MTTKRPs of S starts' factors against one 3-way X as ONE mttkrp
    call: factors (S, n_i, R) laid side by side as (n_i, S*R), so column
    s*R + r is start s's column r (on the card one mttkrp3 call, in column
    blocks of 32, column_blocks).  Returns (S, X.shape[mode], R)."""
    S, _, R = factors[0].shape
    wide = [f.transpose(0, 1).reshape(f.shape[1], S * R) for f in factors]
    out = mttkrp(X, wide, mode)
    return out.reshape(out.shape[0], S, R).transpose(0, 1)


@torch.library.custom_op("matlab_code_tpu_torch::mttkrp_starts",
                         mutates_args=())
def _mttkrp_starts(X: torch.Tensor, factors: list[torch.Tensor], mode: int
                   ) -> torch.Tensor:
    """mttkrp of a 3-way X where X or the factors carry fit_multistart's
    start axis (ops/lanes.py).  The batching rule below runs
    mttkrp_columns where only the factors do, and one call a start where X
    does too (EM imputation gives each start its own X)."""
    return mttkrp(X, factors, mode).clone()


@torch.library.register_vmap("matlab_code_tpu_torch::mttkrp_starts")
def _mttkrp_starts_vmap(info, in_dims, X, factors, mode):
    S = info.batch_size
    facs = [to_front(f, d, S) for f, d in zip(factors, in_dims[1])]
    if in_dims[0] is None:
        return mttkrp_columns(X, facs, mode), 0
    X = to_front(X, in_dims[0], S)
    return torch.stack([mttkrp(X[s], [f[s] for f in facs], mode)
                        for s in range(S)]), 0


def khatri_rao(factors) -> torch.Tensor:
    """Column-wise Khatri-Rao product, rows ordered with the FIRST factor's
    index varying slowest (C order)."""
    R = factors[0].shape[1]
    out = factors[0]
    for f in factors[1:]:
        out = (out[:, None, :] * f[None, :, :]).reshape(-1, R)
    return out


def ktensor_full(factors, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Dense reconstruction sum_r w_r a_r o b_r o c_r ... (full(ktensor),
    cmtf_fun_AOADMM.m:416)."""
    n = len(factors)
    first = factors[0] if weights is None else factors[0] * weights[None, :]
    subs = [f"{_LETTERS[i]}z" for i in range(n)]
    eq = ",".join(subs) + "->" + _LETTERS[:n]
    return torch.einsum(eq, first, *factors[1:])


def mttkrp_sparse(indices: torch.Tensor, values: torch.Tensor, factors,
                  mode: int, out_dim: int, plan: SparsePlan | None = None
                  ) -> torch.Tensor:
    """MTTKRP of a COO sparse tensor, shape (out_dim, R) (Tensor Toolbox
    sptensor mttkrp, cmtf_fun_AOADMM.m:97).  Duplicate coordinates are
    summed.

    COO data on a CUDA card runs the hand-written kernel through `plan`
    (SparseTensor.with_plans; fit attaches plans) and raises without one;
    COO data on the CPU takes the plain gather + index_add_ version.
    Factors on the start axis take _mttkrp_sparse_starts."""
    if on_start_axis(*factors):
        return _mttkrp_sparse_starts(indices, values, list(factors), mode,
                                     out_dim, *plan_fields(plan))
    if values.device.type == "cpu":
        return mttkrp_sparse_reference(indices, values, factors, mode, out_dim)
    if plan is None:
        raise ValueError("mttkrp_sparse: COO data on a CUDA card needs its "
                         "kernel plan (SparseTensor.with_plans; fit attaches "
                         "plans)")
    if plan.out_mode != mode or plan.out_dim != out_dim:
        raise ValueError(f"mttkrp_sparse: the plan is for mode {plan.out_mode} "
                         f"({plan.out_dim} rows), asked for mode {mode} "
                         f"({out_dim} rows)")
    return mttkrp_sparse_cuda(plan, factors)


@torch.library.custom_op("matlab_code_tpu_torch::mttkrp_sparse_starts",
                         mutates_args=())
def _mttkrp_sparse_starts(indices: torch.Tensor, values: torch.Tensor,
                          factors: list[torch.Tensor], mode: int,
                          out_dim: int, plan_tensors: list[torch.Tensor],
                          plan_ints: list[int], variant: str) -> torch.Tensor:
    """mttkrp_sparse where the factors carry fit_multistart's start axis
    (the plan passed as sparse_cuda.plan_fields).  The batching rule below
    lays the S starts' factors (n_i, R) side by side as (n_i, S R), column
    s R + r start s's column r, and makes ONE mttkrp_sparse call of S R
    columns through the plan built at rank R (a group of starts a call
    where sparse_cuda.start_groups splits them)."""
    return mttkrp_sparse(indices, values, factors, mode, out_dim,
                         plan_from_fields(plan_tensors, plan_ints, variant)
                         ).clone()


@torch.library.register_vmap("matlab_code_tpu_torch::mttkrp_sparse_starts")
def _mttkrp_sparse_starts_vmap(info, in_dims, indices, values, factors, mode,
                               out_dim, plan_tensors, plan_ints, variant):
    S = info.batch_size
    facs = [to_front(f, d, S) for f, d in zip(factors, in_dims[2])]
    R = facs[0].shape[2]
    plan = plan_from_fields(plan_tensors, plan_ints, variant)
    outs = []
    for g in start_groups(plan, S, R):
        wide = [f[g].transpose(0, 1).reshape(f.shape[1], -1).contiguous()
                for f in facs]
        out = mttkrp_sparse(indices, values, wide, mode, out_dim, plan)
        outs.append(out.reshape(out_dim, -1, R).transpose(0, 1))
    return torch.cat(outs), 0


def gram(U: torch.Tensor) -> torch.Tensor:
    """U^T U (R x R).  cmtf_fun_AOADMM.m:66."""
    return U.T @ U


def hadamard_grams(grams) -> torch.Tensor:
    """Elementwise product of R x R Grams (cmtf_fun_AOADMM.m:98-103)."""
    out = grams[0]
    for g in grams[1:]:
        out = out * g
    return out


def unfold(X: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-`mode` unfolding (X.shape[mode], prod(rest)), C-order columns."""
    return torch.movedim(X, mode, 0).reshape(X.shape[mode], -1)


def cp_frob_objective(X: torch.Tensor, factors, znorm_const, weight: float
                      ) -> torch.Tensor:
    """w * (||X||^2 - 2<X, M> + ||M||^2) via the MTTKRP trick
    (cp_func.m:37-56 / pca_func.m:29-39)."""
    mk = mttkrp(X, factors, 0)
    f2 = torch.sum(mk * factors[0])
    f3 = torch.sum(hadamard_grams([gram(U) for U in factors]))
    return weight * (znorm_const - 2.0 * f2 + f3)


def masked_frob_norm_sq(X: torch.Tensor, mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """||mask .* X||_F^2 (mask optional)."""
    if mask is None:
        return torch.sum(X * X)
    Xm = torch.where(mask, X, torch.zeros((), dtype=X.dtype, device=X.device))
    return torch.sum(Xm * Xm)
