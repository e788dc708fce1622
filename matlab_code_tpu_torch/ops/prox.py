"""Proximal operators of every CP constraint and regularizer, plus the
constraint -> (prox, reg) dispatch (constraints_to_prox.m:13-91).

Counterpart of matlab_code_tpu/ops/prox.py.  Every prox has the signature
prox(x, rho) -> x_hat, where rho is the ADMM penalty (a number or a 0-d
tensor on x's device); projections ignore it, regularizers use eta / rho
as the reference does.  The sequential proxes (monotone, unimodal, TV) live
in ops/isotonic.py and ops/tv.py and run hand-written kernels on a CUDA
tensor.  'tPARAFAC2' (the joint prox over PARAFAC2 slices) comes with slice
4 and raises NotImplementedError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from matlab_code_tpu_torch.ops.isotonic import project_monotone, project_unimodal
from matlab_code_tpu_torch.ops.tv import prox_tv

KNOWN_CONSTRAINT_KINDS = frozenset({
    "non-negativity", "box", "simplex column-wise", "simplex row-wise",
    "non-decreasing", "non-increasing", "unimodality", "l1-ball", "l2-ball",
    "non-negative l2-ball", "non-negative l2-sphere", "orthonormal",
    "l1 regularization", "l0 regularization", "l2 regularization", "ridge",
    "quadratic regularization", "GL smoothness", "TV regularization",
    "tPARAFAC2", "custom",
})

PORTED_CONSTRAINT_KINDS = KNOWN_CONSTRAINT_KINDS - {"tPARAFAC2"}


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


# ---------------------------------------------------------------------------
# set projections (rho-independent)
# ---------------------------------------------------------------------------


def project_box(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip to [lo, hi] (non-negativity = project_box(x, 0, inf))."""
    return torch.clamp(x, min=lo, max=hi)


def project_simplex_cols(x: torch.Tensor, eta: float) -> torch.Tensor:
    """Euclidean projection of each column onto {v >= 0, sum(v) = eta},
    the sort-based algorithm (Held/Wolfe/Crowder) of the JAX package
    (constraints_to_prox.m:19-21)."""
    n = x.shape[0]
    u = torch.sort(x, dim=0, descending=True).values
    css = torch.cumsum(u, dim=0) - eta
    idx = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)[:, None]
    k = torch.sum(u - css / idx > 0, dim=0)
    # k >= 1 for eta > 0; k == 0 (NaN input) takes the last row, as
    # jnp.take_along_axis does with index -1
    tau = torch.gather(css, 0, ((k - 1) % n)[None, :])[0] / k.to(x.dtype)
    return torch.clamp(x - tau[None, :], min=0.0)


def project_simplex_rows(x: torch.Tensor, eta: float) -> torch.Tensor:
    """Row-wise simplex projection (constraints_to_prox.m:22-24)."""
    return project_simplex_cols(x.T, eta).T


def project_l1ball_cols(x: torch.Tensor, eta: float) -> torch.Tensor:
    """Column-wise projection onto the l1 ball ||v||_1 <= eta
    (constraints_to_prox.m:32-34)."""
    a = torch.abs(x)
    inside = torch.sum(a, dim=0) <= eta
    proj = torch.sign(x) * project_simplex_cols(a, eta)
    return torch.where(inside[None, :], x, proj)


def project_l2ball_cols(x: torch.Tensor, eta: float) -> torch.Tensor:
    """Column-wise projection onto the l2 ball ||v||_2 <= eta
    (constraints_to_prox.m:35-37)."""
    nrm = torch.linalg.vector_norm(x, dim=0)
    scale = torch.where(nrm > eta, eta / torch.clamp(nrm, min=1e-300),
                        torch.ones_like(nrm))
    return x * scale[None, :]


def prox_normalized_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative unit sphere, column-wise; all-negative
    columns map to the indicator of their argmax (prox_normalized_nonneg.m)."""
    y = torch.clamp(x, min=0.0)
    nrm = torch.linalg.vector_norm(y, dim=0)
    onehot = torch.zeros_like(x).scatter_(
        0, torch.argmax(x, dim=0, keepdim=True), 1.0)
    normalized = y / torch.where(nrm == 0, torch.ones_like(nrm), nrm)[None, :]
    return torch.where(nrm[None, :] == 0, onehot, normalized)


def project_orthonormal(x: torch.Tensor) -> torch.Tensor:
    """Polar projection U V^T onto matrices with orthonormal columns
    (project_ortho.m:3-4)."""
    U, _, Vh = torch.linalg.svd(x, full_matrices=False)
    return U @ Vh


# ---------------------------------------------------------------------------
# regularizer proxes (rho-dependent)
# ---------------------------------------------------------------------------


def prox_l1(x: torch.Tensor, gamma) -> torch.Tensor:
    """Soft threshold: prox of gamma*||x||_1 (constraints_to_prox.m:46-49
    with gamma = eta/rho)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - gamma, min=0.0)


def prox_l0(x: torch.Tensor, gamma) -> torch.Tensor:
    """Hard threshold: prox of gamma*||x||_0 keeps |x| > sqrt(2 gamma)
    (constraints_to_prox.m:50-53)."""
    keep = torch.abs(x) > torch.sqrt(torch.as_tensor(2.0 * gamma, dtype=x.dtype,
                                                     device=x.device))
    return torch.where(keep, x, torch.zeros_like(x))


def prox_l2_cols(x: torch.Tensor, gamma) -> torch.Tensor:
    """Column-wise group soft threshold: prox of gamma*sum_r ||x_col||_2
    (constraints_to_prox.m:54-57)."""
    nrm = torch.linalg.vector_norm(x, dim=0)
    scale = torch.clamp(1.0 - gamma / torch.clamp(nrm, min=1e-300), min=0.0)
    return x * scale[None, :]


def make_quadratic_prox(L, eta: float):
    """prox of eta * tr(x^T L x): solves (2 eta/rho L + I) z = x
    (constraints_to_prox.m:62-67) through L's eigendecomposition and a
    rho-dependent spectral filter (two matmuls a call).  L is a matrix
    (tensor or array) or a function of (dtype, device) that builds one; it
    is built, or moved, and decomposed on x's device and in x's dtype at
    the first call there, and kept for the calls that follow."""
    ops = {}

    def operator(x):
        key = (x.device, x.dtype)
        if key not in ops:
            if callable(L):
                Lx = L(x.dtype, x.device)
            else:
                Lx = torch.as_tensor(L if isinstance(L, torch.Tensor)
                                     else np.asarray(L))
                Lx = Lx.to(dtype=x.dtype, device=x.device)
            ops[key] = (Lx, *torch.linalg.eigh(Lx))
        return ops[key]

    def prox(x, rho):
        _, lam, Q = operator(x)
        filt = 1.0 / (2.0 * eta / rho * lam + 1.0)
        return Q @ (filt[:, None] * (Q.T @ x))

    def reg(x):
        Lx = operator(x)[0]
        return eta * torch.trace(x.T @ (Lx @ x))

    return prox, reg


def gl_smoothness_matrix(n: int, dtype=torch.float64, device="cpu"
                         ) -> torch.Tensor:
    """Graph Laplacian of a path graph: 2 on the diagonal (1 at the
    corners), -1 on the first off-diagonals (constraints_to_prox.m:70-74)."""
    L = (2.0 * torch.eye(n, dtype=dtype, device=device)
         - torch.diag(torch.ones(n - 1, dtype=dtype, device=device), 1)
         - torch.diag(torch.ones(n - 1, dtype=dtype, device=device), -1))
    L[0, 0] = 1.0
    L[n - 1, n - 1] = 1.0
    return L


# ---------------------------------------------------------------------------
# constraint spec -> (prox, reg) dispatch
# ---------------------------------------------------------------------------


def make_prox(spec: ConstraintSpec, mode_size: int
              ) -> tuple[Callable, Callable | None]:
    """Build (prox(x, rho), reg(x) or None) for a constraint spec
    (constraints_to_prox.m:13-91).  The operator matrices of 'quadratic
    regularization' and 'GL smoothness' are made on the device and in the
    dtype of the x they are first called with (make_quadratic_prox)."""
    k = spec.kind
    p = spec.params
    if k == "non-negativity":
        return (lambda x, rho: project_box(x, 0.0, math.inf)), None
    if k == "box":
        lo, hi = p
        return (lambda x, rho: project_box(x, lo, hi)), None
    if k == "simplex column-wise":
        eta, = p
        return (lambda x, rho: project_simplex_cols(x, eta)), None
    if k == "simplex row-wise":
        eta, = p
        return (lambda x, rho: project_simplex_rows(x, eta)), None
    if k == "non-decreasing":
        return (lambda x, rho: project_monotone(x, True)), None
    if k == "non-increasing":
        # the reference's -project_monotone(-x, 1) (constraints_to_prox.m:27-28)
        return (lambda x, rho: project_monotone(x, False)), None
    if k == "unimodality":
        nn = bool(p[0])
        return (lambda x, rho: project_unimodal(x, nn)), None
    if k == "l1-ball":
        eta, = p
        return (lambda x, rho: project_l1ball_cols(x, eta)), None
    if k == "l2-ball":
        eta, = p
        return (lambda x, rho: project_l2ball_cols(x, eta)), None
    if k == "non-negative l2-ball":
        eta, = p
        return (lambda x, rho: project_l2ball_cols(
            project_box(x, 0.0, math.inf), eta)), None
    if k == "non-negative l2-sphere":
        return (lambda x, rho: prox_normalized_nonneg(x)), None
    if k == "orthonormal":
        return (lambda x, rho: project_orthonormal(x)), None
    if k == "l1 regularization":
        eta, = p
        return ((lambda x, rho: prox_l1(x, eta / rho)),
                lambda x: eta * torch.sum(torch.abs(x)))
    if k == "l0 regularization":
        eta, = p
        return ((lambda x, rho: prox_l0(x, eta / rho)),
                lambda x: eta * torch.sum(x != 0).to(x.dtype))
    if k == "l2 regularization":
        eta, = p
        return ((lambda x, rho: prox_l2_cols(x, eta / rho)),
                lambda x: eta * torch.sum(torch.linalg.vector_norm(x, dim=0)))
    if k == "ridge":
        eta, = p
        return ((lambda x, rho: x / (2.0 * eta / rho + 1.0)),
                lambda x: eta * torch.sum(x * x))
    if k == "quadratic regularization":
        eta, = p
        return make_quadratic_prox(spec.matrix, eta)
    if k == "GL smoothness":
        eta, = p
        return make_quadratic_prox(
            lambda dtype, device: gl_smoothness_matrix(mode_size, dtype, device),
            eta)
    if k == "TV regularization":
        eta, = p
        # the reference's reg is eta*sum(sum(diff(x))), without abs:
        # replicated literally (constraints_to_prox.m:81)
        return ((lambda x, rho: prox_tv(x, eta / rho)),
                lambda x: eta * torch.sum(x[1:, :] - x[:-1, :]))
    if k == "custom":
        prox_fn = spec.fns[0]
        reg_fn = spec.fns[1] if len(spec.fns) > 1 else None
        return prox_fn, reg_fn
    if k == "tPARAFAC2":
        raise NotImplementedError(
            "constraint 'tPARAFAC2' (the joint temporal-smoothness prox over "
            "PARAFAC2 slices) comes with slice 4 (ROADMAP.md, PARAFAC2)")
    raise ValueError(f"Unknown constraint kind: {k!r}")
