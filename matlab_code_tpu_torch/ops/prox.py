"""Proximal operators of every CP constraint and regularizer, plus the
constraint -> (prox, reg) dispatch (constraints_to_prox.m:13-91).

Counterpart of matlab_code_tpu/ops/prox.py.  Every prox has the signature
prox(x, rho) -> x_hat, where rho is the ADMM penalty (a number or a 0-d
tensor on x's device); projections ignore it, regularizers use eta / rho
as the reference does.  A prox also takes a stack of PARAFAC2 slices x
(K, n, R) with one rho a slice, as a (K, 1, 1) tensor (models/admm.
prox_slicewise): each slice gets the prox of its own (n, R) matrix, in one
batched call (a 'custom' prox is called slice by slice).  The sequential
proxes (monotone, unimodal, TV) live in ops/isotonic.py and ops/tv.py and
run hand-written kernels on a CUDA tensor, as does 'tPARAFAC2' (the joint
temporal-smoothness prox over the K slices, t_smoothness_prox).  Their
proxes also take a padded ragged stack with its slice lengths,
prox(x, rho, sizes=J_k) (`takes_sizes`), one kernel launch for all slices
(models/admm.prox_slicewise_ragged).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from matlab_code_tpu_torch.ops.isotonic import project_monotone, project_unimodal
from matlab_code_tpu_torch.ops.lanes import on_start_axis, to_front
from matlab_code_tpu_torch.ops.tv import prox_tv

KNOWN_CONSTRAINT_KINDS = frozenset({
    "non-negativity", "box", "simplex column-wise", "simplex row-wise",
    "non-decreasing", "non-increasing", "unimodality", "l1-ball", "l2-ball",
    "non-negative l2-ball", "non-negative l2-sphere", "orthonormal",
    "l1 regularization", "l0 regularization", "l2 regularization", "ridge",
    "quadratic regularization", "GL smoothness", "TV regularization",
    "tPARAFAC2", "custom",
})


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
    (constraints_to_prox.m:19-21).  Columns run along axis -2."""
    n = x.shape[-2]
    u = torch.sort(x, dim=-2, descending=True).values
    css = torch.cumsum(u, dim=-2) - eta
    idx = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)[:, None]
    k = torch.sum(u - css / idx > 0, dim=-2, keepdim=True)
    # k >= 1 for eta > 0; k == 0 (NaN input) takes the last row, as
    # jnp.take_along_axis does with index -1
    tau = torch.gather(css, -2, (k - 1) % n) / k.to(x.dtype)
    return torch.clamp(x - tau, min=0.0)


def project_simplex_rows(x: torch.Tensor, eta: float) -> torch.Tensor:
    """Row-wise simplex projection (constraints_to_prox.m:22-24)."""
    return project_simplex_cols(x.transpose(-1, -2), eta).transpose(-1, -2)


def project_l1ball_cols(x: torch.Tensor, eta: float) -> torch.Tensor:
    """Column-wise projection onto the l1 ball ||v||_1 <= eta
    (constraints_to_prox.m:32-34)."""
    a = torch.abs(x)
    inside = torch.sum(a, dim=-2, keepdim=True) <= eta
    proj = torch.sign(x) * project_simplex_cols(a, eta)
    return torch.where(inside, x, proj)


def project_l2ball_cols(x: torch.Tensor, eta: float) -> torch.Tensor:
    """Column-wise projection onto the l2 ball ||v||_2 <= eta
    (constraints_to_prox.m:35-37)."""
    nrm = torch.linalg.vector_norm(x, dim=-2, keepdim=True)
    scale = torch.where(nrm > eta, eta / torch.clamp(nrm, min=1e-300),
                        torch.ones_like(nrm))
    return x * scale


def prox_normalized_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative unit sphere, column-wise; all-negative
    columns map to the indicator of their argmax (prox_normalized_nonneg.m)."""
    y = torch.clamp(x, min=0.0)
    nrm = torch.linalg.vector_norm(y, dim=-2, keepdim=True)
    rows = torch.arange(x.shape[-2], device=x.device)[:, None]
    onehot = (rows == torch.argmax(x, dim=-2, keepdim=True)).to(x.dtype)
    normalized = y / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return torch.where(nrm == 0, onehot, normalized)


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
    nrm = torch.linalg.vector_norm(x, dim=-2, keepdim=True)
    scale = torch.clamp(1.0 - gamma / torch.clamp(nrm, min=1e-300), min=0.0)
    return x * scale


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
        filt = 1.0 / (2.0 * eta / rho * lam[:, None] + 1.0)
        return Q @ (filt * (Q.T @ x))

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


def t_smoothness_prox(Bs: torch.Tensor, rho: torch.Tensor, eta: float
                      ) -> torch.Tensor:
    """tPARAFAC2 temporal-smoothness joint prox over the K slice matrices
    (functions/t_smoothness_prox.m:23-56): the block-tridiagonal system with
    diagonal 4 eta + rho_k (2 eta + rho_k at both ends), off-diagonal
    -2 eta and right-hand side rho_k B_k, by the Thomas algorithm.  Bs
    (K, J, R), rho (K,).  A CUDA tensor goes to the hand-written kernel
    ops/prox_cuda.t_smooth_cols (kernel C); a CPU tensor takes the plain
    version, t_smoothness_reference."""
    if on_start_axis(Bs, rho):
        return _t_smoothness_starts(Bs, torch.as_tensor(
            rho, dtype=Bs.dtype, device=Bs.device), float(eta))
    if Bs.device.type == "cuda":
        from matlab_code_tpu_torch.ops.prox_cuda import t_smooth_cols
        return t_smooth_cols(Bs.contiguous(), rho, eta)
    if Bs.device.type != "cpu":
        raise ValueError(f"t_smoothness_prox: unsupported device {Bs.device}")
    return t_smoothness_reference(Bs, rho, eta)


@torch.library.custom_op("matlab_code_tpu_torch::t_smoothness_starts",
                         mutates_args=())
def _t_smoothness_starts(Bs: torch.Tensor, rho: torch.Tensor, eta: float
                         ) -> torch.Tensor:
    """t_smoothness_prox where Bs or rho carries fit_multistart's start axis
    (ops/lanes.py).  Kernel C takes one rho a slice for all of a slice's
    elements, and each start has its own rho, so the batching rule below
    runs one launch a start (one plain version a start on the CPU)."""
    return t_smoothness_prox(Bs, rho, eta).clone()


@torch.library.register_vmap("matlab_code_tpu_torch::t_smoothness_starts")
def _t_smoothness_starts_vmap(info, in_dims, Bs, rho, eta):
    S = info.batch_size
    Bs = to_front(Bs, in_dims[0], S)
    rho = to_front(rho, in_dims[1], S)
    return torch.stack([t_smoothness_prox(Bs[s], rho[s], eta)
                        for s in range(S)]), 0


def t_smoothness_reference(Bs: torch.Tensor, rho: torch.Tensor, eta: float
                           ) -> torch.Tensor:
    """The plain version of kernel C: the two scans of the JAX package's
    t_smoothness_prox (matlab_code_tpu/ops/prox.py:144-188) as loops over k,
    in its order of operations and in Bs's dtype."""
    K = Bs.shape[0]
    eta = torch.tensor(eta, dtype=Bs.dtype, device=Bs.device)
    diag = 4.0 * eta + rho.to(Bs.dtype)
    diag[0] = diag[0] + -2.0 * eta
    diag[K - 1] = diag[K - 1] + -2.0 * eta
    off = -2.0 * eta
    rhs = rho.to(Bs.dtype)[:, None, None] * Bs
    # forward elimination: d'_i = d_i - (off / d'_{i-1}) off,
    # r'_i = r_i - (off / d'_{i-1}) r'_{i-1}
    dmod, rmod = [diag[0]], [rhs[0]]
    for i in range(1, K):
        m = off / dmod[-1]
        dmod.append(diag[i] - m * off)
        rmod.append(rhs[i] - m * rmod[-1])
    # back substitution: x_K = r'_K / d'_K, x_i = (r'_i - off x_{i+1}) / d'_i
    xs = [None] * K
    xs[K - 1] = rmod[K - 1] / dmod[K - 1]
    for i in range(K - 2, -1, -1):
        xs[i] = (rmod[i] - off * xs[i + 1]) / dmod[i]
    return torch.stack(xs)


def t_smoothness_penalty(Bs: torch.Tensor, eta: float) -> torch.Tensor:
    """eta * sum_k ||B_k - B_{k-1}||_F^2 (t_smoothness_penalty.m:5-9)."""
    d = Bs[1:] - Bs[:-1]
    return eta * torch.sum(d * d)


def _takes_sizes(prox):
    """Mark a prox whose kernels take a padded ragged stack in one call,
    prox(x, rho, sizes=J_k), each slice's true rows only."""
    prox.takes_sizes = True
    return prox


def _custom_prox(fn):
    """A user's prox of one (n, R) matrix, called slice by slice on a
    (K, n, R) stack with the slice's rho."""
    def prox(x, rho):
        if x.dim() == 2:
            return fn(x, rho)
        r = rho.reshape(-1) if isinstance(rho, torch.Tensor) else None
        return torch.stack([fn(x[k], rho if r is None or r.numel() == 1
                               else r[k]) for k in range(x.shape[0])])
    return prox


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
        return _takes_sizes(lambda x, rho, sizes=None:
                            project_monotone(x, True, sizes)), None
    if k == "non-increasing":
        # the reference's -project_monotone(-x, 1) (constraints_to_prox.m:27-28)
        return _takes_sizes(lambda x, rho, sizes=None:
                            project_monotone(x, False, sizes)), None
    if k == "unimodality":
        nn = bool(p[0])
        return _takes_sizes(lambda x, rho, sizes=None:
                            project_unimodal(x, nn, sizes)), None
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
        return (_takes_sizes(lambda x, rho, sizes=None:
                             prox_tv(x, eta / rho, sizes)),
                lambda x: eta * torch.sum(x[1:, :] - x[:-1, :]))
    if k == "tPARAFAC2":
        eta, = p
        return ((lambda Bs, rho: t_smoothness_prox(Bs, rho, eta)),
                lambda Bs: t_smoothness_penalty(Bs, eta))
    if k == "custom":
        prox_fn = spec.fns[0]
        reg_fn = spec.fns[1] if len(spec.fns) > 1 else None
        return _custom_prox(prox_fn), reg_fn
    raise ValueError(f"Unknown constraint kind: {k!r}")
