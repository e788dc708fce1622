"""Hand-written Hopper kernel for the dense 3-way MTTKRP (modes 0, 1, 2).

Counterpart of matlab_code_tpu/ops/mttkrp_pallas.py.  The kernel
(csrc/mttkrp3.cu) replaces the Pallas kernel `mttkrp3_mode0`
(mttkrp_pallas.py:50-83, pallas_call at :60) and extends it to modes 1 and
2, so every dense 3-way MTTKRP of the AO sweep runs through it.

What bounds it on the H100: ~2R flops per 4-byte element of X (8-15
flop/byte at R = 16-20), far below the float32 ridge, so the roof is X's
bytes over HBM bandwidth.  The kernel reads X once, coalesced along the
contiguous k axis, keeps the other factors in registers and shared memory,
and reduces split partial sums in a fixed second pass instead of with
atomics, so repeated calls give the same bits.  See the source for the
layout of each mode.

mttkrp3(X, factors, mode) launches the kernel for a CUDA tensor and raises
on anything it does not take; for a CPU tensor it returns the plain
version, mttkrp3_reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

R_MAX = 32                  # largest rank the kernel takes (registers)
_RM_BUCKETS = (8, 16, 24, 32)
_ROWS_THREADS = 256         # block size of the mode-0/1 kernel
_ROWS_TARGET_BLOCKS = 1024  # enough blocks of 8 warps to fill 132 SMs
_MODE2_TARGET_WARPS = 2048  # mode 2: more warps means more split partials
_TILE_BYTES = 16384         # shared-memory budget of one factor tile
_GRID_YZ_MAX = 65535

_LIB = None


class Plan(NamedTuple):
    """Launch plan of one mttkrp3 call (see csrc/mttkrp3.cu)."""
    rm: int      # rank padded to a register bucket
    tk: int      # threads along k
    ns_a: int    # modes 0/1: splits of the walked axis; mode 2: splits of i
    ns_b: int    # mode 2: splits of j (1 otherwise)
    per_a: int   # rows per split of the ns_a axis
    per_b: int   # rows per split of the ns_b axis

    @property
    def nsplit(self) -> int:
        return self.ns_a * self.ns_b


def _pow2_clamp(n: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, 1 << max(0, (n - 1).bit_length())))


def _splits(n: int, want: int) -> tuple[int, int]:
    """(splits, rows per split) covering n rows with about `want` splits and
    no empty split."""
    want = max(1, min(n, want))
    per = math.ceil(n / want)
    return math.ceil(n / per), per


def plan_mttkrp3(shape: tuple[int, int, int], R: int, mode: int,
                 itemsize: int) -> Plan:
    """Launch plan for an (I, J, K) tensor at rank R; raises on what the
    kernel does not take."""
    I, J, K = shape
    if min(I, J, K) < 1:
        raise ValueError(f"mttkrp3 needs I, J, K >= 1, got {shape}")
    if not 1 <= R <= R_MAX:
        raise ValueError(f"mttkrp3 takes 1 <= R <= {R_MAX}, got R={R}")
    if mode not in (0, 1, 2):
        raise ValueError(f"mttkrp3 mode must be 0, 1 or 2, got {mode}")
    rm = next(b for b in _RM_BUCKETS if b >= R)
    tile_rows = max(1, _TILE_BYTES // (rm * itemsize))
    if mode < 2:
        O, Sn = (I, J) if mode == 0 else (J, I)
        tk = _pow2_clamp(K, 32, _ROWS_THREADS)
        want = max(math.ceil(_ROWS_TARGET_BLOCKS / O), math.ceil(Sn / tile_rows))
        ns, per = _splits(Sn, want)
        plan = Plan(rm, tk, ns, 1, per, 1)
    else:
        tk = _pow2_clamp(K, 32, 128)
        ktiles = math.ceil(K / tk)
        target = max(1, _MODE2_TARGET_WARPS // (tk // 32))
        nj_min = math.ceil(J / tile_rows)
        ni, per_i = _splits(I, math.ceil(target / (ktiles * nj_min)))
        nj, per_j = _splits(J, max(nj_min, math.ceil(target / (ktiles * ni))))
        plan = Plan(rm, tk, ni, nj, per_i, per_j)
    if plan.ns_a > _GRID_YZ_MAX or plan.ns_b > _GRID_YZ_MAX:
        raise ValueError(f"mttkrp3: shape {shape} needs more than "
                         f"{_GRID_YZ_MAX} splits")
    return plan


def mttkrp3_reference(X: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """Plain PyTorch version: the einsum of ops/tensor.mttkrp for a 3-way X,
    in promote(X.dtype, float32)."""
    dt = torch.promote_types(X.dtype, torch.float32)
    A, B, C = (f.to(dt) for f in factors)
    X = X.to(dt)
    if mode == 0:
        return torch.einsum("ijk,jr,kr->ir", X, B, C)
    if mode == 1:
        return torch.einsum("ijk,ir,kr->jr", X, A, C)
    return torch.einsum("ijk,ir,jr->kr", X, A, B)


def _lib():
    global _LIB
    if _LIB is None:
        from matlab_code_tpu_torch.ops._build import load_library
        lib = load_library("mttkrp3", ["mttkrp3.cu"])
        fn = lib.mttkrp3_run
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def mttkrp3(X: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """Mode-`mode` MTTKRP of a dense (I, J, K) tensor; factors (A, B, C) with
    shapes (I, R), (J, R), (K, R) (factors[mode] is not read).  Returns
    (X.shape[mode], R) in promote(X.dtype, float32).

    A CUDA tensor launches the hand-written kernel (and counts the launch in
    mttkrp3.launches) or raises; a CPU tensor takes mttkrp3_reference."""
    if X.device.type == "cpu":
        return mttkrp3_reference(X, factors, mode)
    if X.device.type != "cuda":
        raise ValueError(f"mttkrp3: unsupported device {X.device}")
    if X.dim() != 3 or len(factors) != 3:
        raise ValueError(f"mttkrp3 takes a 3-way tensor and 3 factors, got "
                         f"X.dim()={X.dim()} and {len(factors)} factors")
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"mttkrp3 takes float32 or float64, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("mttkrp3 takes a contiguous X (it never copies X)")
    ref = factors[(mode + 1) % 3]
    R = ref.shape[1] if ref.dim() == 2 else -1
    for n, f in enumerate(factors):
        if n == mode:
            continue
        if f.device != X.device or f.dtype != X.dtype:
            raise ValueError(f"mttkrp3: factor {n} is {f.dtype} on {f.device}, "
                             f"X is {X.dtype} on {X.device}")
        if f.dim() != 2 or f.shape != (X.shape[n], R) or not f.is_contiguous():
            raise ValueError(f"mttkrp3: factor {n} must be a contiguous "
                             f"({X.shape[n]}, {R}) matrix, got {tuple(f.shape)}")
    plan = plan_mttkrp3(tuple(X.shape), R, mode, X.element_size())
    I, J, K = X.shape
    out = torch.empty((X.shape[mode], R), dtype=X.dtype, device=X.device)
    part = (torch.empty((plan.nsplit, X.shape[mode], R), dtype=X.dtype,
                        device=X.device) if plan.nsplit > 1 else out)
    A, B, C = factors
    f0, f1 = ((B, C), (A, C), (A, B))[mode]
    err = _lib().mttkrp3_run(
        int(X.dtype == torch.float64), plan.rm, mode, X.data_ptr(),
        f0.data_ptr(), f1.data_ptr(), part.data_ptr(), out.data_ptr(),
        I, J, K, R, plan.tk, plan.ns_a, plan.ns_b, plan.per_a, plan.per_b,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mttkrp3 launch failed: cudaError {err} "
                           f"(shape {tuple(X.shape)}, R={R}, mode={mode}, {plan})")
    mttkrp3.launches += 1
    return out


mttkrp3.launches = 0
