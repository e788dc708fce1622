"""Loss constants (counterpart of matlab_code_tpu/ops/losses.py).  Only the
Frobenius loss is ported; KL, IS and beta come with slice 5."""
from __future__ import annotations

import torch

FROBENIUS = "Frobenius"


def znorm_const(loss: str, X: torch.Tensor, eps_log: float,
                beta: float | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Data-only additive constant of the loss (cmtf_AOADMM.m:130-189)."""
    if loss == FROBENIUS:
        Xm = X if mask is None else torch.where(
            mask, X, torch.zeros((), dtype=X.dtype, device=X.device))
        return torch.sum(Xm * Xm)
    raise NotImplementedError(
        f"loss {loss!r} is not ported yet: the port has the Frobenius loss "
        "only; KL/IS/beta come with slice 5 (ROADMAP.md, non-Frobenius losses)")
