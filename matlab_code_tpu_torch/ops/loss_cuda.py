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
plain version (ops/losses.loss_fg_reference).  Each call is counted in
`loss_fg_cuda.launches`.  Nothing is built at import: the first call builds
the library (ops/_build.py).
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
        lib.loss_fg_run.argtypes = [i, i, p, p, p, l, d, d, p, i, p, p]
        lib.loss_fg_run.restype = i
        _LIB = lib
    return _LIB


def grid_blocks(n: int, sms: int) -> int:
    """Blocks of the pass for n elements on a card of `sms` SMs: one block
    per THREADS elements, at most BLOCKS_PER_SM an SM (each thread then
    walks its elements a grid apart).  A function of n and the card only,
    so the partial sums, and f's bits, are too."""
    return max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms))


def loss_fg_cuda(loss: str, X: torch.Tensor, M: torch.Tensor, eps_log: float,
                 beta: float | None = None):
    """Kernel D: (sum fh(X, M), gh(X, M)) for loss 'KL', 'IS' or 'beta'."""
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
    if M.shape != X.shape or M.dtype != X.dtype or M.device != X.device:
        raise ValueError(f"loss_fg_cuda: X {tuple(X.shape)} {X.dtype} and M "
                         f"{tuple(M.shape)} {M.dtype} differ")
    Y = torch.empty_like(X)
    f = torch.empty((), dtype=X.dtype, device=X.device)
    n = X.numel()
    if n == 0:
        return f.zero_(), Y
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    blocks = grid_blocks(n, sms)
    partials = torch.empty(blocks, dtype=torch.float64, device=X.device)
    err = _lib().loss_fg_run(
        int(X.dtype == torch.float64), LOSS_CODES[loss], X.data_ptr(),
        M.data_ptr(), Y.data_ptr(), n, float(eps_log),
        0.0 if beta is None else float(beta), partials.data_ptr(), blocks,
        f.data_ptr(), torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"loss_fg_cuda ({loss}) launch failed: cudaError "
                           f"{err} ({'x'.join(map(str, X.shape))} {X.dtype})")
    loss_fg_cuda.launches += 1
    return f, Y


loss_fg_cuda.launches = 0
