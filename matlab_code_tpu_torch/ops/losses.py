"""Loss functions: squared Frobenius and the beta-divergence family
(counterpart of matlab_code_tpu/ops/losses.py; cmtf_AOADMM.m:123-190).

Each non-Frobenius loss has an elementwise fh(X, M) and its gradient
gh(X, M) = d fh / d M, and a data-only constant Znorm_const, so that
loss = Znorm_const + sum(fh(X, M)).  The formulas are the JAX module's,
literally: eps_log inside the logs and divisions of KL and IS, none in
the beta terms.

loss_fg(loss, X, M, eps_log, beta) is the one pass every non-Frobenius
evaluation makes: (sum fh, gh).  On a CUDA tensor it launches kernel D
(ops/loss_cuda.loss_fg_cuda, csrc/loss_fg.cu); on a CPU tensor it takes the
plain version, loss_fg_reference.  On fit_multistart's start axis
(ops/lanes.py) it is a custom operator whose batching rule makes the pass
of every start at once: one launch of kernel D on the card
(loss_cuda.loss_fg_cuda_starts), the plain version over the start axis on
the CPU.
"""
from __future__ import annotations

import math

import torch

from matlab_code_tpu_torch.ops.lanes import on_start_axis, to_front
from matlab_code_tpu_torch.ops.loss_cuda import (
    loss_fg_cuda, loss_fg_cuda_starts)

FROBENIUS = "Frobenius"
KL = "KL"
IS = "IS"
BETA = "beta"


def znorm_const(loss: str, X: torch.Tensor, eps_log: float,
                beta: float | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Data-only additive constant of the loss (cmtf_AOADMM.m:130-189)."""
    if loss == FROBENIUS:
        Xm = X if mask is None else torch.where(
            mask, X, torch.zeros((), dtype=X.dtype, device=X.device))
        return torch.sum(Xm * Xm)
    if loss == KL:
        return torch.sum(X * torch.log(X + eps_log) - X)
    if loss == IS:
        return torch.sum(-torch.log(X + eps_log) - 1.0)
    if loss == BETA:
        return torch.sum(X ** beta) / (beta * (beta - 1.0))
    raise ValueError(f"Unknown loss {loss!r}")


def loss_fh(loss: str, X, M, eps_log: float, beta: float | None = None):
    """Elementwise fh(X, M) (cmtf_AOADMM.m:168, 178, 185)."""
    if loss == KL:
        return M - X * torch.log(M + eps_log)
    if loss == IS:
        return X / (M + eps_log) + torch.log(M + eps_log)
    if loss == BETA:
        return (1.0 / beta) * M ** beta - (1.0 / (beta - 1.0)) * X * M ** (beta - 1.0)
    raise ValueError(f"No fh for loss {loss!r}")


def loss_gh(loss: str, X, M, eps_log: float, beta: float | None = None):
    """Elementwise gradient gh(X, M) with respect to M (cmtf_AOADMM.m:169,
    179, 186)."""
    if loss == KL:
        return 1.0 - X / (M + eps_log)
    if loss == IS:
        return -X / ((M + eps_log) ** 2) + 1.0 / (M + eps_log)
    if loss == BETA:
        return M ** (beta - 1.0) - X * M ** (beta - 2.0)
    raise ValueError(f"No gh for loss {loss!r}")


def loss_bounds(loss: str) -> tuple[float, float]:
    """Box bounds of the L-BFGS-B factor subproblem (cmtf_AOADMM.m:170-188)."""
    if loss == FROBENIUS:
        return (-math.inf, math.inf)
    return (0.0, math.inf)


def loss_fg_reference(loss: str, X: torch.Tensor, M: torch.Tensor,
                      eps_log: float, beta: float | None = None):
    """The plain version of kernel D: (sum fh(X, M), gh(X, M)), a 0-d tensor
    and a tensor of X's shape, in X's dtype."""
    return (torch.sum(loss_fh(loss, X, M, eps_log, beta)),
            loss_gh(loss, X, M, eps_log, beta))


def loss_fg(loss: str, X: torch.Tensor, M: torch.Tensor, eps_log: float,
            beta: float | None = None):
    """(sum fh(X, M), gh(X, M)): kernel D for CUDA tensors (which raises on
    what it does not take: another dtype, a non-contiguous X or M), the
    plain version for CPU tensors; on the start axis, _loss_fg_starts."""
    if on_start_axis(X, M):
        return _loss_fg_starts(X, M, loss, eps_log, beta)
    if X.device.type == "cuda":
        return loss_fg_cuda(loss, X, M, eps_log, beta)
    return loss_fg_reference(loss, X, M, eps_log, beta)


@torch.library.custom_op("matlab_code_tpu_torch::loss_fg_starts",
                         mutates_args=())
def _loss_fg_starts(X: torch.Tensor, M: torch.Tensor, loss: str,
                    eps_log: float, beta: float | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """loss_fg where X or M carries fit_multistart's start axis; the
    batching rule below makes the pass of every start at once."""
    f, Y = loss_fg(loss, X, M, eps_log, beta)
    return f.clone(), Y.clone()


@torch.library.register_vmap("matlab_code_tpu_torch::loss_fg_starts")
def _loss_fg_starts_vmap(info, in_dims, X, M, loss, eps_log, beta):
    S = info.batch_size
    M = to_front(M, in_dims[1], S).contiguous()
    if in_dims[0] is not None:
        X = to_front(X, in_dims[0], S).contiguous()
    if M.device.type == "cuda":
        return loss_fg_cuda_starts(loss, X, M, eps_log, beta), (0, 0)
    fh = loss_fh(loss, X, M, eps_log, beta)
    return (torch.sum(fh.reshape(S, -1), dim=1),
            loss_gh(loss, X, M, eps_log, beta)), (0, 0)
