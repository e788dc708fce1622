"""Loss functions: squared Frobenius and the beta-divergence family
(counterpart of matlab_code_tpu/ops/losses.py; cmtf_AOADMM.m:123-190).

Each non-Frobenius loss has an elementwise fh(X, M) and its gradient
gh(X, M) = d fh / d M, and a data-only constant Znorm_const, so that
loss = Znorm_const + sum(fh(X, M)).  The formulas are the JAX module's,
literally: eps_log inside the logs and divisions of KL and IS, none in
the beta terms.

loss_fg_mttkrp(loss, X, factors, mode, eps_log, beta, grad) is the data
pass of a non-Frobenius evaluation of a dense 3-way dataset: (sum fh(X, M),
the MTTKRP of gh(X, M) into `mode`) with M the CP model of the factors
(lbfgs_bridge's value and gradient; with grad=False the objective's sum
fh).  On CUDA tensors it launches the fused kernel D
(ops/loss_cuda.loss_fg_mttkrp_cuda, csrc/loss_fg.cu), which forms M in
registers: one launch, no M or gh in device memory.  On CPU tensors it
makes the three-call evaluation (ktensor_full, loss_fg, mttkrp), which
there is the plain version, loss_fg_mttkrp_reference, op for op.  On
fit_multistart's start axis (ops/lanes.py) it is a custom operator whose
batching rule makes the evaluation of every start in one launch
(loss_cuda.loss_fg_mttkrp_cuda_starts).

loss_fg(loss, X, M, eps_log, beta) is the pass of every other
non-Frobenius dataset (2-way, order above 3, a block cut over a mesh, a
rank past FUSED_MAX_RANK):
(sum fh, gh) from a given M.  On a CUDA tensor it launches the old pass
of kernel D (ops/loss_cuda.loss_fg_cuda); on a CPU tensor it takes the
plain version, loss_fg_reference.  On the start axis it is a custom
operator whose batching rule makes the pass of every start at once: one
launch on the card (loss_cuda.loss_fg_cuda_starts), the plain version over
the start axis on the CPU.
"""
from __future__ import annotations

import math

import torch

from matlab_code_tpu_torch.ops.lanes import on_start_axis, to_front
from matlab_code_tpu_torch.ops.loss_cuda import (
    loss_fg_cuda, loss_fg_cuda_starts, loss_fg_mttkrp_cuda,
    loss_fg_mttkrp_cuda_starts)
from matlab_code_tpu_torch.ops.tensor import (
    ktensor_full, mttkrp, mttkrp_einsum)

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


# The widest rank the fused route takes, by dtype: where the fused call's
# device time (mean of modes 0-2) stays within 1.25x that of the three-call
# evaluation (model, old pass, mttkrp3) at 128 x 256 x 256 on an H100
# (utils/time_fused.py; PERF.md): float32 1.08x at R 16, 1.59x at R 32;
# float64 1.09x at R 8, 1.86x at R 16.  Past it the kernel's model and
# MTTKRP (3R operations an element, in registers that spill) cost more
# than the three calls' bytes.  Within it the fused call also saves the
# two other calls' host time.
FUSED_MAX_RANK = {torch.float32: 16, torch.float64: 8}


def takes_fused(X, rank: int, cut: bool) -> bool:
    """True where a non-Frobenius dataset's evaluations take
    loss_fg_mttkrp: a dense 3-way float32 or float64 tensor that is not
    cut over a mesh, of rank FUSED_MAX_RANK[dtype] at most.  Decided from
    the dataset and its rank alone, before any launch; every other dataset
    (2-way, order above 3, sparse, a cut block, a wider rank) keeps
    ktensor_full, loss_fg and its MTTKRP."""
    return (isinstance(X, torch.Tensor) and X.dim() == 3 and not cut
            and rank <= FUSED_MAX_RANK.get(X.dtype, 0))


def loss_fg_mttkrp_reference(loss: str, X: torch.Tensor, factors, mode: int,
                             eps_log: float, beta: float | None = None,
                             grad: bool = True):
    """The plain version of the fused kernel D: M = ktensor_full(factors),
    (sum fh, gh) by loss_fg_reference, the MTTKRP of gh by torch.einsum.
    Returns (f, G or None)."""
    f, Y = loss_fg_reference(loss, X, ktensor_full(factors), eps_log, beta)
    return f, mttkrp_einsum(Y, factors, mode) if grad else None


def loss_fg_mttkrp(loss: str, X: torch.Tensor, factors, mode: int,
                   eps_log: float, beta: float | None = None,
                   grad: bool = True):
    """(sum fh(X, M), MTTKRP(gh(X, M), factors, mode)) of a dense 3-way X,
    M = ktensor_full(factors); with grad=False (f, None).  CUDA tensors:
    the fused kernel D (which raises on what it does not take: another
    dtype, a non-contiguous X, R past 64), one launch, on the start axis
    one launch for every start (_loss_fg_mttkrp_starts).  CPU tensors:
    ktensor_full, loss_fg and mttkrp, the plain version's operations (and
    on the start axis the CPU's batching rules of loss_fg and mttkrp)."""
    if X.device.type == "cuda":
        if on_start_axis(X, *factors):
            f, G = _loss_fg_mttkrp_starts(X, list(factors), mode, loss,
                                          eps_log, beta, grad)
            return f, G if grad else None
        return loss_fg_mttkrp_cuda(loss, X, [F.contiguous() for F in factors],
                                   mode, eps_log, beta, grad)
    f, Y = loss_fg(loss, X, ktensor_full(factors).contiguous(), eps_log, beta)
    return f, mttkrp(Y, factors, mode) if grad else None


@torch.library.custom_op("matlab_code_tpu_torch::loss_fg_mttkrp_starts",
                         mutates_args=())
def _loss_fg_mttkrp_starts(X: torch.Tensor, factors: list[torch.Tensor],
                           mode: int, loss: str, eps_log: float,
                           beta: float | None, grad: bool
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """loss_fg_mttkrp where X or the factors carry fit_multistart's start
    axis; the batching rule below makes the evaluation of every start at
    once.  Without grad the second output is an empty tensor."""
    if X.device.type == "cuda":
        f, G = loss_fg_mttkrp_cuda(loss, X, [F.contiguous() for F in factors],
                                   mode, eps_log, beta, grad)
    else:
        f, G = loss_fg_mttkrp_reference(loss, X, factors, mode, eps_log,
                                        beta, grad)
    return f.clone(), G.clone() if grad else X.new_empty((0,))


@torch.library.register_vmap("matlab_code_tpu_torch::loss_fg_mttkrp_starts")
def _loss_fg_mttkrp_starts_vmap(info, in_dims, X, factors, mode, loss,
                                eps_log, beta, grad):
    S = info.batch_size
    facs = [to_front(F, d, S).contiguous()
            for F, d in zip(factors, in_dims[1])]
    if in_dims[0] is not None:
        X = to_front(X, in_dims[0], S).contiguous()
    if X.device.type == "cuda":
        f, G = loss_fg_mttkrp_cuda_starts(loss, X, facs, mode, eps_log, beta,
                                          grad)
    else:
        per = [loss_fg_mttkrp_reference(
            loss, X if in_dims[0] is None else X[s], [F[s] for F in facs],
            mode, eps_log, beta, grad) for s in range(S)]
        f = torch.stack([p[0] for p in per])
        G = torch.stack([p[1] for p in per]) if grad else None
    if not grad:
        return (f, X.new_empty((0,))), (0, None)
    return (f, G), (0, 0)
