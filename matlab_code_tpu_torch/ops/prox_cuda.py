"""Hand-written Hopper kernels for the sequential per-column proxes
(csrc/prox_seq.cu):

  project_isotonic_cols (kernel A)  non-decreasing, non-increasing and
      unimodal (optionally non-negative) projections; replaces the lax
      loops of matlab_code_tpu/ops/isotonic.py (no pallas_call there)
  prox_tv_cols (kernel B)  the exact TV prox, Condat's algorithm;
      replaces the lax loop of matlab_code_tpu/ops/tv.py

Each takes a contiguous (n, R) float32 or float64 CUDA matrix and returns a
new one; one thread walks a column, as the plain versions
(ops/isotonic.columns_reference, ops/tv.columns_reference) do on the host.
Kernel A's per-slot scan state lives in a workspace allocated here.  Each
launch is counted in the wrapper's `launches`.  Nothing is built at import:
the first call builds the library (ops/_build.py).
"""
from __future__ import annotations

import ctypes

import torch

_LIB = None
KERNEL_DTYPES = (torch.float32, torch.float64)


def _lib():
    global _LIB
    if _LIB is None:
        from matlab_code_tpu_torch.ops._build import load_library
        lib = load_library("prox_seq", ["prox_seq.cu"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.project_isotonic_cols_run.argtypes = [i, i, i, p, p, i, i, p, p, p]
        lib.prox_tv_cols_run.argtypes = [i, p, p, i, i, p, p]
        lib.project_isotonic_cols_run.restype = i
        lib.prox_tv_cols_run.restype = i
        _LIB = lib
    return _LIB


def _check(X: torch.Tensor, name: str) -> None:
    if X.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor, got one on {X.device}")
    if X.dim() != 2 or X.dtype not in KERNEL_DTYPES or not X.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (n, R) float32 or float64 "
                         f"matrix, got {tuple(X.shape)} {X.dtype}, contiguous "
                         f"{X.is_contiguous()}")


def _stream(X: torch.Tensor) -> int:
    return torch.cuda.current_stream(X.device).cuda_stream


def project_isotonic_cols(X: torch.Tensor, kind: int, nonneg: bool = False
                          ) -> torch.Tensor:
    """Kernel A on every column of X: kind 0 non-decreasing, 1
    non-increasing, 2 unimodal (non-negative where nonneg)."""
    _check(X, "project_isotonic_cols")
    n, R = X.shape
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    sides = 2 if kind == 2 else 1
    ws_d = torch.empty(4 * sides * (n + 1) * R, dtype=torch.float64,
                       device=X.device)
    ws_i = torch.empty(sides * (n + 1) * R, dtype=torch.int32, device=X.device)
    err = _lib().project_isotonic_cols_run(
        int(X.dtype == torch.float64), kind, int(bool(nonneg)), X.data_ptr(),
        out.data_ptr(), n, R, ws_d.data_ptr(), ws_i.data_ptr(), _stream(X))
    if err != 0:
        raise RuntimeError(f"project_isotonic_cols launch failed: cudaError "
                           f"{err} ({n}x{R} {X.dtype}, kind {kind})")
    project_isotonic_cols.launches += 1
    return out


project_isotonic_cols.launches = 0


def prox_tv_cols(X: torch.Tensor, lam) -> torch.Tensor:
    """Kernel B on every column of X with strength lam (a number or a 0-d
    tensor; a CUDA tensor is read by the kernel, never by the host)."""
    _check(X, "prox_tv_cols")
    n, R = X.shape
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    lam_t = torch.as_tensor(lam, dtype=torch.float64).to(X.device).reshape(())
    err = _lib().prox_tv_cols_run(
        int(X.dtype == torch.float64), X.data_ptr(), out.data_ptr(), n, R,
        lam_t.data_ptr(), _stream(X))
    if err != 0:
        raise RuntimeError(f"prox_tv_cols launch failed: cudaError {err} "
                           f"({n}x{R} {X.dtype})")
    prox_tv_cols.launches += 1
    return out


prox_tv_cols.launches = 0
