"""Small dense linear algebra of the ADMM updates and of nvecs init
(counterpart of the CP part of matlab_code_tpu/ops/linalg.py).  The
systems are R x R, or mode-sized for the Sylvester solve of coupling types
1 and 5.  block_diag and the Newton / polar solvers come with PARAFAC2
(slice 4).

chol_lower returns NaNs for a matrix that is not positive definite, as
jnp.linalg.cholesky does, instead of raising like torch.linalg.cholesky:
the solver turns a non-finite factor into the ill-conditioning flag
(models/admm._chol_rcond_bad).
"""
from __future__ import annotations

import torch


def chol_lower(B: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric positive-definite B (chol(B',
    'lower'), cmtf_fun_AOADMM.m:142); all-NaN where B is not positive
    definite.  Batched over leading dims."""
    L, info = torch.linalg.cholesky_ex(B)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def solve_with_chol(L: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Solve X B = A for X given B = L L^T: the reference's (A/L')/L
    (cmtf_fun_AOADMM.m:609).  A: (I, R)."""
    y = torch.linalg.solve_triangular(L, A.transpose(-1, -2), upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x.transpose(-1, -2)


def spd_inverse_from_chol(L: torch.Tensor) -> torch.Tensor:
    """B^{-1} = L^{-T} L^{-1} from the lower Cholesky factor of B."""
    R = L.shape[-1]
    eye = torch.eye(R, dtype=L.dtype, device=L.device).expand(L.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


def solve_spd_left(L: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Solve B X = A given B = L L^T.  A: (n, k)."""
    y = torch.linalg.solve_triangular(L, A, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^{-1} B for general square A, like jnp.linalg.solve: a singular A
    gives non-finite values instead of an error, and on CUDA the solve does
    not wait for the device to check for one."""
    return torch.linalg.solve_ex(A, B)[0]


def rsolve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """MATLAB A/B (solve X B = A) for general square B, solved with the
    transpose as in the JAX package: solve(B^T, A^T)^T."""
    return solve(B.transpose(-1, -2), A.transpose(-1, -2)).transpose(-1, -2)


def top_eigvecs(Y: torch.Tensor, r: int) -> torch.Tensor:
    """Leading-r eigenvectors (by eigenvalue) of symmetric PSD Y, like
    eigs(Y, r, 'LM') (init_coupled_AOADMM_CMTF.m:60, cmtf_nvecs.m), with the
    JAX package's sign convention: the largest-|.| entry of each vector is
    made positive."""
    _, V = torch.linalg.eigh(Y)          # ascending
    V = V.flip(-1)[:, :r]
    idx = torch.argmax(V.abs(), dim=0)
    signs = torch.sign(V[idx, torch.arange(r, device=V.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return V * signs[None, :]


def sylvester_solver(B2: torch.Tensor, B: torch.Tensor):
    """Solver of B2 X + X B = C for SYMMETRIC B2 (n x n) and B (R x R),
    MATLAB's sylvester(B2, B, C) at cmtf_fun_AOADMM.m:728 (coupling types 1
    and 5: B2 = rho/2 H^T H [+ rho/2 I], B = the weighted Gram), solved
    spectrally as the JAX package's sylvester_sym does: B2 = U1 S1 U1^T,
    B = U2 S2 U2^T, X = U1 [(U1^T C U2) / (s1_i + s2_j)] U2^T.  The two
    eigendecompositions are taken once, here; each call of the returned
    function does the arithmetic of one sylvester_sym."""
    s1, U1 = torch.linalg.eigh(B2)
    s2, U2 = torch.linalg.eigh(B)
    denom = s1[:, None] + s2[None, :]
    return lambda C: U1 @ ((U1.T @ C @ U2) / denom) @ U2.T


def sylvester_sym(B2: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                  ) -> torch.Tensor:
    """Solve B2 X + X B = C for symmetric B2 and B (sylvester_solver)."""
    return sylvester_solver(B2, B)(C)
