"""Isotonic and unimodal regression of matrix columns, counterpart of
matlab_code_tpu/ops/isotonic.py (the reference's project_unimodal_vector.m,
Stout 2008's prefix-isotonic algorithm, and the Proximity Operator
Repository's project_monotone, dispatched at constraints_to_prox.m:25-31).

The merge loop is sequential and data-dependent.  A CUDA tensor goes to the
hand-written kernel `project_isotonic_cols` (csrc/prox_seq.cu, bound in
ops/prox_cuda.py): a block a scan side of a column (a unimodal column is
a cluster of two), one thread walking the same recurrence with its state
in shared memory (in device memory for columns too long for it); a stack
of many columns, or a ragged one, a thread a scan side and a warp 32
columns (the lanes route).  A CPU
tensor takes the plain version below: a Python walk of each column in the
JAX module's order of merges and arithmetic, in float64 whatever the
tensor's dtype (the kernel also computes in float64), so float64 results
agree with the JAX package to rounding.  The plain version reads every
value on the host, so it is never run on a card tensor.
"""
from __future__ import annotations

import math

import torch

INCREASING, DECREASING, UNIMODAL = 0, 1, 2


def _prefix_isotonic(y: list, nonneg: bool, steps: list | None = None):
    """Prefix isotonic regression scan (project_unimodal_vector.m:43-88).

    y: the column as Python floats.  Returns (level, idxr, err), lists of
    length n+1 whose slot 0 is a sentinel; slot i (1..n) describes the
    isotonic fit of the prefix y[:i]: level[i] the mean of its last level
    set (0 where nonneg and the mean is negative), idxr[i] the leftmost
    slot of that set, err[i] the fit's total squared error.  steps, when
    given, gets the walk's dependent steps (one a slot and one a merge)."""
    n = len(y)
    sumwy = [0.0] + list(y)
    sumwy2 = [0.0] + [v * v for v in y]
    sumw = [0.0] + [1.0] * n
    level = [-math.inf] + [0.0] * n
    idxr = [0] * (n + 1)
    err = [0.0] * (n + 1)
    cum = 0.0                      # sum of y^2 over the slots before i
    merges = 0
    for i in range(1, n + 1):
        level[i] = y[i - 1]
        idxr[i] = i
        # never past slot 0 (the kernel's sentinel level is NaN): a column
        # holding -inf would merge into it and walk off the list
        while idxr[i] > 1 and level[i] <= level[idxr[i] - 1]:
            merger = idxr[i] - 1
            sumwy[i] += sumwy[merger]
            sumwy2[i] += sumwy2[merger]
            sumw[i] += sumw[merger]
            level[i] = sumwy[i] / sumw[i]
            idxr[i] = idxr[merger]
            merges += 1
        levelerror = sumwy2[i] - sumwy[i] * sumwy[i] / sumw[i]
        if nonneg and level[i] < 0:
            err[i] = cum
        else:
            err[i] = levelerror + err[idxr[i] - 1]
        cum += y[i - 1] * y[i - 1]
    if nonneg:
        level = [0.0 if v < 0 else v for v in level]
        level[0] = -math.inf
    if steps is not None:
        steps.append(n + merges)
    return level, idxr, err


def _reconstruct(mode_idx: int, level: list, idxr: list, n: int) -> list:
    """The fit of the prefix of length mode_idx, rebuilt by walking the
    level-set pointers (project_unimodal_vector.m:34-41); a length-n list
    whose first mode_idx entries are the fit."""
    out = [0.0] * n
    idx = mode_idx
    while idx >= 1:
        left = idxr[idx]
        for j in range(left - 1, idx):
            out[j] = level[idx]
        idx = left - 1
    return out


def _argmin_first(vals: list) -> int:
    """Index of the first minimum, or of the first NaN (jnp.argmin)."""
    best = 0
    for i, v in enumerate(vals):
        if v != v:
            return i
        if v < vals[best]:
            best = i
    return best


def isotonic_list(y: list, increasing: bool = True, steps=None) -> list:
    x = y if increasing else [-v for v in y]
    n = len(x)
    level, idxr, _ = _prefix_isotonic(x, False, steps)
    out = _reconstruct(n, level, idxr, n)
    return out if increasing else [-v for v in out]


def unimodal_list(y: list, nonneg: bool, steps=None) -> list:
    n = len(y)
    lv_l, ir_l, err_l = _prefix_isotonic(y, nonneg, steps)
    lv_r, ir_r, err_r = _prefix_isotonic(y[::-1], nonneg, steps)
    # errs[i-1] = error_left(i) + error_right(n-i+1), i = 1..n
    errs = [err_l[i] + err_r[n - i + 1] for i in range(1, n + 1)]
    best = _argmin_first(errs) + 1
    left = _reconstruct(best, lv_l, ir_l, n)
    right = _reconstruct(n - best, lv_r, ir_r, n)
    return [left[p] if p < best else right[n - 1 - p] for p in range(n)]


def isotonic_vector(y: torch.Tensor, increasing: bool = True) -> torch.Tensor:
    """L2 isotonic regression of a CPU vector (PAVA)."""
    return torch.tensor(isotonic_list(y.tolist(), increasing), dtype=y.dtype)


def unimodal_vector(y: torch.Tensor, nonneg: bool) -> torch.Tensor:
    """Unimodal (optionally nonnegative) L2 regression of a CPU vector:
    prefix-isotonic scans from the left and from the flipped right, the
    peak at the first minimum of their summed errors, both halves rebuilt."""
    return torch.tensor(unimodal_list(y.tolist(), nonneg), dtype=y.dtype)


def columns_reference(X: torch.Tensor, kind: int, nonneg: bool = False,
                      steps: list | None = None) -> torch.Tensor:
    """The plain version of kernel A on a CPU matrix (n, R) or stack of
    slices (K, n, R): kind INCREASING, DECREASING or UNIMODAL, column by
    column, in float64, returned in X.dtype.  steps, when given, gets each
    scan's dependent steps."""
    n, R = X.shape[-2:]
    cols = X.detach().to(torch.float64).reshape(-1, n, R).transpose(
        1, 2).reshape(-1, n).tolist()
    if kind == UNIMODAL:
        out = [unimodal_list(c, nonneg, steps) for c in cols]
    else:
        out = [isotonic_list(c, kind == INCREASING, steps) for c in cols]
    return torch.tensor(out, dtype=torch.float64).reshape(-1, R, n).transpose(
        1, 2).to(X.dtype).reshape(X.shape)


def ragged_reference(X: torch.Tensor, sizes, fn) -> torch.Tensor:
    """A padded ragged stack X (K, Jmax, R) through fn(slice) on each
    slice's true J_k rows, the padded rows zero: the plain version of the
    kernels' ragged form (shared with ops/tv.py)."""
    if X.dim() != 3 or len(sizes) != X.shape[0]:
        raise ValueError(f"ragged sizes: {len(sizes)} lengths for a stack "
                         f"of shape {tuple(X.shape)}")
    out = torch.zeros_like(X)
    for k, J in enumerate(sizes):
        out[k, :J] = fn(k, X[k, :J])
    return out


def _columns(X: torch.Tensor, kind: int, nonneg: bool, sizes=None
             ) -> torch.Tensor:
    if X.device.type == "cuda":
        from matlab_code_tpu_torch.ops.prox_cuda import project_isotonic_cols
        return project_isotonic_cols(X.contiguous(), kind, nonneg, sizes)
    if X.device.type != "cpu":
        raise ValueError(f"isotonic projection: unsupported device {X.device}")
    if sizes is not None:
        return ragged_reference(
            X, sizes, lambda k, M: columns_reference(M, kind, nonneg))
    return columns_reference(X, kind, nonneg)


def project_monotone(X: torch.Tensor, increasing: bool = True, sizes=None
                     ) -> torch.Tensor:
    """Column-wise monotone projection of an (n, R) matrix or of each slice
    of a (K, n, R) stack (of its true J_k rows where the stack is ragged,
    sizes the J_k; padded rows zero); non-increasing negates in and out,
    as the reference's -project_monotone(-x, 1)."""
    return _columns(X, INCREASING if increasing else DECREASING, False, sizes)


def project_unimodal(X: torch.Tensor, nonneg: bool, sizes=None
                     ) -> torch.Tensor:
    """Column-wise unimodal projection of an (n, R) matrix or of each slice
    of a (K, n, R) stack, ragged as project_monotone (project_unimodal.m)."""
    return _columns(X, UNIMODAL, nonneg, sizes)
