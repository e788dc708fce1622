"""Exact 1-D total-variation prox of matrix columns (Condat's direct
algorithm), counterpart of matlab_code_tpu/ops/tv.py (the reference's
prox_TV.m around TV_Condat_v2.m).  For each column y it solves

    min_x 1/2 ||x - y||^2 + lam * sum_i |x[i+1] - x[i]|

A CUDA tensor goes to the hand-written kernel `prox_tv_cols`
(csrc/prox_seq.cu, bound in ops/prox_cuda.py): a block a column, one
thread running the state machine below on the column staged in shared
memory (in device memory for columns too long for it); a stack of many
columns, or a ragged one, a thread a column and a warp 32 columns (the
lanes route).  A CPU
tensor takes the plain version: a Python walk of each column in the JAX
module's order of states and arithmetic, in float64 whatever the tensor's
dtype (the kernel also computes in float64).
lam may be a number or a 0-d tensor (eta / rho), or one value a slice for
a stack of PARAFAC2 slices; lam <= 0 and columns of length 1 return y.
"""
from __future__ import annotations

from typing import Optional

import torch

from matlab_code_tpu_torch.ops.lanes import on_start_axis, to_front


def tv_list(y: list, lam: float, steps: list | None = None) -> list:
    """Condat's state machine on one column of Python floats, with the JAX
    module's states (1-based k as in the paper; `fresh` marks a segment
    just started by a jump).  steps, when given, gets the number of
    states walked."""
    n = len(y)
    if n == 1 or not lam > 0:
        if steps is not None:
            steps.append(0)
        return list(y)
    x = [0.0] * n
    k = k0 = km = kp = 1
    vmin, vmax, umin, umax = y[0] - lam, y[0] + lam, lam, -lam
    fresh = True
    walked = 0

    def seg(lo, hi, v):
        for i in range(lo - 1, hi):
            x[i] = v

    while True:
        walked += 1
        if k == n:
            if fresh:
                x[n - 1] = vmin + umin
                break
            if umin < 0:
                seg(k0, km, vmin)
                k = k0 = km = km + 1
                vmin, umin = y[k - 1], lam
                umax = y[k - 1] + lam - vmax
            elif umax > 0:
                seg(k0, kp, vmax)
                k = k0 = kp = kp + 1
                vmax, umax = y[k - 1], -lam
                umin = y[k - 1] - lam - vmin
            else:
                seg(k0, k, vmin + umin / (k - k0 + 1))
                break
            fresh = True
            continue
        ynext = y[k]
        if ynext + umin < vmin - lam:          # negative jump
            seg(k0, km, vmin)
            k = k0 = km = kp = km + 1
            vmin, vmax = y[k - 1], y[k - 1] + 2 * lam
            umin, umax = lam, -lam
            fresh = True
        elif ynext + umax > vmax + lam:        # positive jump
            seg(k0, kp, vmax)
            k = k0 = km = kp = kp + 1
            vmin, vmax = y[k - 1] - 2 * lam, y[k - 1]
            umin, umax = lam, -lam
            fresh = True
        else:                                  # extend the segment
            k += 1
            umin = umin + y[k - 1] - vmin
            umax = umax + y[k - 1] - vmax
            denom = k - k0 + 1
            if umin >= lam:
                vmin = vmin + (umin - lam) / denom
                km, umin = k, lam
            if umax <= -lam:
                vmax = vmax + (umax + lam) / denom
                kp, umax = k, -lam
            fresh = False
    if steps is not None:
        steps.append(walked)
    return x


def tv_denoise_vector(y: torch.Tensor, lam) -> torch.Tensor:
    """Exact TV prox of a CPU vector y with strength lam (lam >= 0)."""
    return torch.tensor(tv_list(y.tolist(), float(lam)), dtype=y.dtype)


def columns_reference(X: torch.Tensor, lam, steps: list | None = None
                      ) -> torch.Tensor:
    """The plain version of kernel B on a CPU matrix (n, R) or stack of
    slices (K, n, R), column by column, in float64, returned in X.dtype.
    lam: a number, or a tensor of one value or of one a slice (K values).
    steps, when given, gets each column's states walked."""
    n, R = X.shape[-2:]
    Xs = X.detach().to(torch.float64).reshape(-1, n, R)
    lams = torch.as_tensor(lam, dtype=torch.float64).reshape(-1).tolist()
    if len(lams) == 1:
        lams = lams * Xs.shape[0]
    out = [[tv_list(c, lam_k, steps) for c in M.T.tolist()]
           for M, lam_k in zip(Xs, lams)]
    return torch.tensor(out, dtype=torch.float64).reshape(
        Xs.shape[0], R, n).transpose(1, 2).to(X.dtype).reshape(X.shape)


def prox_tv(X: torch.Tensor, lam, sizes=None) -> torch.Tensor:
    """Column-wise TV prox of an (n, R) matrix (functions/prox_TV.m), or of
    each slice of a (K, n, R) stack with its own lam (K values); of each
    slice's true J_k rows where the stack is ragged (sizes the J_k; padded
    rows zero)."""
    if on_start_axis(X, lam):
        return _prox_tv_starts(
            X, torch.as_tensor(lam, dtype=X.dtype, device=X.device),
            None if sizes is None else list(sizes))
    if X.device.type == "cuda":
        from matlab_code_tpu_torch.ops.prox_cuda import prox_tv_cols
        return prox_tv_cols(X.contiguous(), lam, sizes)
    if X.device.type != "cpu":
        raise ValueError(f"prox_tv: unsupported device {X.device}")
    if sizes is not None:
        from matlab_code_tpu_torch.ops.isotonic import ragged_reference
        lams = torch.as_tensor(lam, dtype=torch.float64).reshape(-1)
        lams = lams.expand(X.shape[0]) if lams.numel() == 1 else lams
        return ragged_reference(
            X, sizes, lambda k, M: columns_reference(M, lams[k]))
    return columns_reference(X, lam)


@torch.library.custom_op("matlab_code_tpu_torch::tv_starts", mutates_args=())
def _prox_tv_starts(X: torch.Tensor, lam: torch.Tensor,
                    sizes: Optional[list[int]]) -> torch.Tensor:
    """prox_tv where X or lam carries fit_multistart's start axis
    (ops/lanes.py): the batching rule below folds the starts into the slice
    axis, each slice with its start's lam, so the S starts' columns are one
    kernel launch (one plain walk on the CPU)."""
    return prox_tv(X, lam, sizes).clone()


@torch.library.register_vmap("matlab_code_tpu_torch::tv_starts")
def _prox_tv_starts_vmap(info, in_dims, X, lam, sizes):
    S = info.batch_size
    X = to_front(X, in_dims[0], S)
    K = X.shape[1] if X.dim() == 4 else 1
    lam = to_front(lam, in_dims[1], S).reshape(S, -1).expand(S, K)
    out = prox_tv(X.reshape(-1, *X.shape[-2:]), lam.reshape(-1),
                  None if sizes is None else list(sizes) * S)
    return out.reshape(X.shape), 0
