"""Factor match score (FMS) and Fit% (counterpart of
matlab_code_tpu/utils/score.py): the Tensor Toolbox `score` with
'lambda_penalty', false, as every example script evaluates a fit
(example_script1:141-152).

congruence(r, s) = prod over modes of |<a_r, b_s>| / (||a_r|| ||b_s||);
the score is the mean of the congruences under the best component matching
(optimal assignment via scipy's Hungarian solver).  Every function takes
numpy arrays or torch tensors (read on the host in float64)."""
from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):        # a torch tensor, on any device
        a = a.detach().cpu().numpy()
    return np.asarray(a, float)


def fms(factors_a, factors_b, lambda_penalty: bool = False,
        lambdas_a=None, lambdas_b=None) -> float:
    """factors_*: lists of (I_m, R) matrices (same shapes)."""
    R = factors_a[0].shape[1]
    C = np.ones((R, R))
    for A, B in zip(factors_a, factors_b):
        A = _host(A)
        B = _host(B)
        An = A / np.maximum(np.linalg.norm(A, axis=0, keepdims=True), 1e-300)
        Bn = B / np.maximum(np.linalg.norm(B, axis=0, keepdims=True), 1e-300)
        C *= np.abs(An.T @ Bn)
    if lambda_penalty and lambdas_a is not None:
        la = np.abs(_host(lambdas_a))
        lb = np.abs(_host(lambdas_b))
        pen = 1.0 - np.abs(la[:, None] - lb[None, :]) / np.maximum(
            la[:, None], lb[None, :])
        C *= pen
    try:
        from scipy.optimize import linear_sum_assignment
        ri, ci = linear_sum_assignment(-C)
        return float(C[ri, ci].mean())
    except ImportError:
        from itertools import permutations
        best = -np.inf
        for perm in permutations(range(R)):
            v = np.mean([C[i, perm[i]] for i in range(R)])
            best = max(best, v)
        return float(best)


def fms_par2_B(Bk_a, Bk_b) -> float:
    """FMS of the row-concatenated PARAFAC2 Bk stacks
    (example_script1:146-152)."""
    A = np.concatenate([_host(b) for b in Bk_a], axis=0)
    B = np.concatenate([_host(b) for b in Bk_b], axis=0)
    return fms([A], [B])


def fit_score(X, Xhat) -> float:
    """Fit% = 100 * (1 - ||X - Xhat||^2 / ||X||^2) (example_script1:131-138)."""
    X = _host(X)
    Xhat = _host(Xhat)
    return 100.0 * (1.0 - np.sum((X - Xhat) ** 2) / np.sum(X ** 2))
