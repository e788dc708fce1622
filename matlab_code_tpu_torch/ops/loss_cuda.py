"""Kernel D, the hand-written Hopper loss pass (csrc/loss_fg.cu): in one
pass over the data X and the model M it computes (sum fh(X, M), gh(X, M))
of the KL, Itakura-Saito and beta-divergence losses, the formulas of
ops/losses.py.  It replaces no Pallas kernel: the JAX package leaves the
pass to XLA, fused inside the L-BFGS-B value and gradient
(matlab_code_tpu/models/lbfgs_bridge.py:45-47) and the objective
(matlab_code_tpu/models/objective.py:84-87).

loss_fg_cuda takes contiguous float32 or float64 CUDA tensors X and M of
one shape and any length, launches on torch's current stream and returns a
0-d tensor f (sum fh, in X's dtype, summed in float64 in a fixed order, so
two calls give the same bits) and Y (gh, X's shape and dtype).  It raises
on anything else, and on a build or launch error; nothing falls back to the
plain version (ops/losses.loss_fg_reference).  loss_fg_cuda_starts makes
the pass of S problems in one launch (fit_multistart's starts: M of shape
(S, ...), X shared or of M's shape), each start's f and Y the bits of its
own loss_fg_cuda call.  Each call of either is counted in
`loss_fg_cuda.launches`.  Nothing is built at import: the first call
builds the library (ops/_build.py).
"""
from __future__ import annotations

import ctypes

import torch

_LIB = None
KERNEL_DTYPES = (torch.float32, torch.float64)
LOSS_CODES = {"KL": 0, "IS": 1, "beta": 2}   # enum Loss of csrc/loss_fg.cu
THREADS = 256           # kThreads: threads a block of the pass
BLOCKS_PER_SM = 8       # blocks of the pass an SM (2,048 threads)


def _lib():
    global _LIB
    if _LIB is None:
        from matlab_code_tpu_torch.ops._build import load_library
        lib = load_library("loss_fg", ["loss_fg.cu"])
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        d = ctypes.c_double
        lib.loss_fg_run.argtypes = [i, i, p, l, p, p, l, i, d, d, p, i, p, p]
        lib.loss_fg_run.restype = i
        _LIB = lib
    return _LIB


def grid_blocks(n: int, sms: int) -> int:
    """Blocks of the pass for n elements on a card of `sms` SMs: one block
    per THREADS elements, at most BLOCKS_PER_SM an SM (each thread then
    walks its elements a grid apart).  A function of n and the card only,
    so the partial sums, and f's bits, are too."""
    return max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms))


def _check(loss: str, beta, X: torch.Tensor, M: torch.Tensor) -> None:
    if loss not in LOSS_CODES:
        raise ValueError(f"loss_fg_cuda: no kernel for loss {loss!r}")
    if loss == "beta" and beta is None:
        raise ValueError("loss_fg_cuda: the beta loss needs its beta")
    for name, t in (("X", X), ("M", M)):
        if t.device.type != "cuda":
            raise ValueError(f"loss_fg_cuda: {name} is on {t.device}, not a "
                             "CUDA card")
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"loss_fg_cuda: {name} is {t.dtype}; the kernel "
                             "takes float32 or float64")
        if not t.is_contiguous():
            raise ValueError(f"loss_fg_cuda: {name} is not contiguous")
    if M.dtype != X.dtype or M.device != X.device:
        raise ValueError(f"loss_fg_cuda: X {X.dtype} on {X.device} and M "
                         f"{M.dtype} on {M.device} differ")


def _launch(loss: str, X: torch.Tensor, M: torch.Tensor, starts: int,
            x_stride: int, eps_log: float, beta):
    """Both passes for `starts` problems of n = M.numel() / starts elements
    each; returns (f of shape (starts,), Y of M's shape)."""
    Y = torch.empty_like(M)
    f = torch.empty((starts,), dtype=M.dtype, device=M.device)
    n = M.numel() // starts
    if n == 0:
        return f.zero_(), Y
    sms = torch.cuda.get_device_properties(M.device).multi_processor_count
    blocks = grid_blocks(n, sms)
    partials = torch.empty((starts, blocks), dtype=torch.float64,
                           device=M.device)
    err = _lib().loss_fg_run(
        int(M.dtype == torch.float64), LOSS_CODES[loss], X.data_ptr(),
        x_stride, M.data_ptr(), Y.data_ptr(), n, starts, float(eps_log),
        0.0 if beta is None else float(beta), partials.data_ptr(), blocks,
        f.data_ptr(), torch.cuda.current_stream(M.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"loss_fg_cuda ({loss}) launch failed: cudaError "
                           f"{err} ({starts} x {n} {M.dtype})")
    loss_fg_cuda.launches += 1
    return f, Y


def loss_fg_cuda(loss: str, X: torch.Tensor, M: torch.Tensor, eps_log: float,
                 beta: float | None = None):
    """Kernel D: (sum fh(X, M), gh(X, M)) for loss 'KL', 'IS' or 'beta'."""
    _check(loss, beta, X, M)
    if M.shape != X.shape:
        raise ValueError(f"loss_fg_cuda: X {tuple(X.shape)} and M "
                         f"{tuple(M.shape)} differ")
    f, Y = _launch(loss, X, M, 1, 0, eps_log, beta)
    return f[0], Y


def loss_fg_cuda_starts(loss: str, X: torch.Tensor, M: torch.Tensor,
                        eps_log: float, beta: float | None = None):
    """Kernel D for S starts in one launch: M (S, ...) the starts' models,
    X their data (M.shape[1:], shared, or M's shape).  Returns (f (S,), Y
    of M's shape), start s's the bits of loss_fg_cuda(loss, X[s], M[s])."""
    _check(loss, beta, X, M)
    S = M.shape[0]
    if X.shape == M.shape[1:]:
        x_stride = 0
    elif X.shape == M.shape:
        x_stride = X[0].numel()
    else:
        raise ValueError(f"loss_fg_cuda_starts: X {tuple(X.shape)} for M "
                         f"{tuple(M.shape)} of {S} starts")
    if not 1 <= S <= 65535:
        raise ValueError(f"loss_fg_cuda_starts: {S} starts (1 to 65535)")
    return _launch(loss, X, M, S, x_stride, eps_log, beta)


loss_fg_cuda.launches = 0
