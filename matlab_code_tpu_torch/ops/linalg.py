"""Small dense linear algebra of the ADMM updates and of nvecs init
(counterpart of matlab_code_tpu/ops/linalg.py).  The systems are R x R,
K-batched R x R for PARAFAC2, mode-sized for the Sylvester solve of
coupling types 1 and 5, or (K*R) x (K*R) for a PARAFAC2 C mode under
coupling type 1 or 5 (block_diag).

The JAX package's two adaptive Newton iterations (spd_inverse_newton,
polar_orth_ns) exit a lax.while_loop once a residual drops below a
tolerance.  Here each runs its full iteration bound with the update
masked after the exit (torch.where on a device flag): the same iterates,
the same result, and no host sync.

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


def spd_inverse_newton(B: torch.Tensor, lmin=None, max_iters: int = 24,
                       polish: int = 2):
    """Batched SPD inverse by Newton-Hotelling iteration, matmuls only
    (matlab_code_tpu/ops/linalg.py::spd_inverse_newton): X_{t+1} = X_t (2I -
    B X_t) from X_0 = c I, c = 2 / (lmin + ||B||_inf) (1 / ||B||_inf without
    lmin), while max|B X - I| > tol (1e-2 in float32, 1e-6 otherwise) and at
    most max_iters steps, then `polish` steps.  lmin: None, a number or a
    (K,) tensor.  Returns (B^{-1}, rcond estimate 1 / (||B||_inf
    ||B^{-1}||_inf))."""
    R = B.shape[-1]
    eye = torch.eye(R, dtype=B.dtype, device=B.device)
    ninf = torch.amax(torch.sum(torch.abs(B), dim=-1), dim=-1)
    if lmin is None:
        c = 1.0 / ninf
    else:
        c = 2.0 / (ninf + torch.as_tensor(lmin, dtype=B.dtype, device=B.device))
    X = c[..., None, None] * eye.expand(B.shape)
    tol = 1e-2 if B.dtype == torch.float32 else 1e-6
    active = torch.ones((), dtype=torch.bool, device=B.device)
    for _ in range(max_iters):
        E = B @ X
        res = torch.amax(torch.abs(E - eye))
        X = torch.where(active, X @ (2.0 * eye - E), X)
        active = active & (res > tol)
    for _ in range(polish):
        E = B @ X
        X = X @ (2.0 * eye - E)
    xinf = torch.amax(torch.sum(torch.abs(X), dim=-1), dim=-1)
    return X, 1.0 / (ninf * xinf)


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


def polar_orth(M: torch.Tensor) -> torch.Tensor:
    """Orthonormal polar factor U V^T of M by thin SVD ([U,~,V] =
    svd(M,'econ'); U*V', cmtf_fun_AOADMM.m:532-534).  Batched over leading
    dims."""
    U, _, Vh = torch.linalg.svd(M, full_matrices=False)
    return U @ Vh


def polar_orth_ns(M: torch.Tensor, iters: int = 30, polish: int = 2
                  ) -> torch.Tensor:
    """Orthonormal polar factor of M by cubic Newton-Schulz iteration,
    matmuls only (matlab_code_tpu/ops/linalg.py::polar_orth_ns): X_0 =
    M / ||M||_F, X <- 1.5 X - 0.5 X (X^T X) while the largest max|X^T X - I|
    of the nonzero slices exceeds tol (1e-2 in float32, 1e-6 otherwise), at
    most `iters` steps, then `polish` steps.  Zero slices stay zero.
    Batched over leading dims."""
    nrm = torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True))
    X = M / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    tol = 1e-2 if M.dtype == torch.float32 else 1e-6
    nonzero = nrm[..., 0, 0] > 0
    active = torch.ones((), dtype=torch.bool, device=M.device)
    for _ in range(iters):
        G = X.transpose(-1, -2) @ X
        res = torch.amax(torch.abs(G - eye), dim=(-2, -1))
        res = torch.amax(torch.where(nonzero, res, torch.zeros_like(res)))
        X = torch.where(active, 1.5 * X - 0.5 * X @ G, X)
        active = active & (res > tol)
    for _ in range(polish):
        G = X.transpose(-1, -2) @ X
        X = 1.5 * X - 0.5 * (X @ G)
    return X


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


def block_diag(mats: torch.Tensor) -> torch.Tensor:
    """Block-diagonal matrix of a stacked batch (K, R, R) -> (K*R, K*R),
    blkdiag(B{m}{:}) at cmtf_fun_AOADMM.m:286."""
    K, R, _ = mats.shape
    eye_k = torch.eye(K, dtype=mats.dtype, device=mats.device)
    return (eye_k[:, None, :, None] * mats[:, :, None, :]).reshape(K * R, K * R)
