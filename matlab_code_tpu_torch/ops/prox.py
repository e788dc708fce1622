"""Proximal operators for the main path, plus the constraint -> prox dispatch.

Counterpart of matlab_code_tpu/ops/prox.py.  Every prox has the signature
prox(x, rho) -> x_hat.  This slice carries the projections the flagship
and the script-3/6 configurations use ('non-negativity', 'box',
'non-negative l2-sphere'); every other kind raises NotImplementedError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

KNOWN_CONSTRAINT_KINDS = frozenset({
    "non-negativity", "box", "simplex column-wise", "simplex row-wise",
    "non-decreasing", "non-increasing", "unimodality", "l1-ball", "l2-ball",
    "non-negative l2-ball", "non-negative l2-sphere", "orthonormal",
    "l1 regularization", "l0 regularization", "l2 regularization", "ridge",
    "quadratic regularization", "GL smoothness", "TV regularization",
    "tPARAFAC2", "custom",
})

PORTED_CONSTRAINT_KINDS = frozenset({
    "non-negativity", "box", "non-negative l2-sphere"})


@dataclass(frozen=True)
class ConstraintSpec:
    """Static description of one mode's constraint (same fields and checks
    as matlab_code_tpu.ops.prox.ConstraintSpec)."""
    kind: str
    params: tuple = ()
    matrix: Any = None
    fns: tuple = ()

    def __post_init__(self):
        if self.kind not in KNOWN_CONSTRAINT_KINDS:
            raise ValueError(
                f"Unknown constraint kind: {self.kind!r}; known kinds: "
                f"{sorted(KNOWN_CONSTRAINT_KINDS)}")
        if self.kind == "custom" and not self.fns:
            raise ValueError(
                "ConstraintSpec('custom') requires fns=(prox_fn[, reg_fn]) "
                "(constraints_to_prox.m:86-90 takes the handles in the cell)")
        if self.kind == "quadratic regularization" and self.matrix is None:
            raise ValueError(
                "ConstraintSpec('quadratic regularization') requires the "
                "matrix= L operand (constraints_to_prox.m:62-67)")

    def __hash__(self):
        return hash((self.kind, self.params, id(self.matrix), self.fns))

    def __eq__(self, other):
        return (isinstance(other, ConstraintSpec)
                and self.kind == other.kind and self.params == other.params
                and self.matrix is other.matrix and self.fns == other.fns)


def project_box(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip to [lo, hi] (non-negativity = project_box(x, 0, inf))."""
    return torch.clamp(x, min=lo, max=hi)


def prox_normalized_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative unit sphere, column-wise; all-negative
    columns map to the indicator of their argmax (prox_normalized_nonneg.m)."""
    y = torch.clamp(x, min=0.0)
    nrm = torch.linalg.vector_norm(y, dim=0)
    onehot = torch.zeros_like(x).scatter_(
        0, torch.argmax(x, dim=0, keepdim=True), 1.0)
    normalized = y / torch.where(nrm == 0, torch.ones_like(nrm), nrm)[None, :]
    return torch.where(nrm[None, :] == 0, onehot, normalized)


def make_prox(spec: ConstraintSpec, mode_size: int, dtype=None
              ) -> tuple[Callable, Callable | None]:
    """Build (prox(x, rho), reg(x) or None) for a constraint spec
    (constraints_to_prox.m:13-91)."""
    k = spec.kind
    if k == "non-negativity":
        return (lambda x, rho: project_box(x, 0.0, math.inf)), None
    if k == "box":
        lo, hi = spec.params
        return (lambda x, rho: project_box(x, lo, hi)), None
    if k == "non-negative l2-sphere":
        return (lambda x, rho: prox_normalized_nonneg(x)), None
    raise NotImplementedError(
        f"constraint {k!r} is not ported yet: the port carries "
        f"{sorted(PORTED_CONSTRAINT_KINDS)}; the other proxes come with "
        "slice 3 (ROADMAP.md, 'the rest of the CP surface')")
