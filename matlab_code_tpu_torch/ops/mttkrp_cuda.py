"""Hand-written Hopper kernel for the dense 3-way MTTKRP (modes 0, 1, 2).

Counterpart of matlab_code_tpu/ops/mttkrp_pallas.py.  The kernel
(csrc/mttkrp3.cu) replaces the Pallas kernel `mttkrp3_mode0`
(mttkrp_pallas.py:50-83, pallas_call at :60) and extends it to modes 1 and
2, so every dense 3-way MTTKRP of the AO sweep runs through it.  Like the
Pallas kernel it takes X in float16, bfloat16, float32 or float64 and
accumulates and returns promote(X.dtype, float32): a 16-bit X is widened to
float32 as it is loaded.

What bounds it on the H100: ~2R flops per 4-byte element of X (8-15
flop/byte at R = 16-20), far below the float32 ridge, so the roof is X's
bytes over HBM bandwidth.  The kernel reads X once, coalesced along the
contiguous k axis, keeps the other factors in registers and shared memory,
and reduces split partial sums in a fixed second pass instead of with
atomics, so repeated calls give the same bits.  Every mode streams X
through a ring of asynchronous copies, about one block an SM: modes 0 and 1
as tiles of output rows against ranges of walked rows (RowsStreamPlan),
mode 2 as the (I*J) x K matrix X is (StreamPlan).  See the source for the
layout of each mode.

mttkrp3(X, factors, mode) launches the kernel for a CUDA tensor (once per
column block of at most R_MAX past R_MAX) and raises on anything it does
not take; for a CPU tensor it returns the plain version, mttkrp3_reference.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

# dtypes of X the kernel takes, and their codes in csrc/mttkrp3.cu (XDtype)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
KERNEL_DTYPES = tuple(DTYPE_CODES)
R_MAX = 32                  # largest rank one launch takes (registers)
_RM_BUCKETS = (8, 16, 24, 32)
_GRID_YZ_MAX = 65535
# the stream kernels (constants shared with csrc/mttkrp3.cu)
STREAM_THREADS = 256        # kStreamThreads: consumer threads a block at most
STREAM_STAGES = 4           # slots of the ring the plans take
PLAIN_COPY = 1              # kPlainCopy: a copy width of plain loads/stores
ENVELOPE_COPY = 2           # kEnvelope: X's runs as bulk copies of their
#                             16-byte-aligned envelopes (rows-stream kernel)
_STAGE_BYTES = 32768        # X bytes a stage holds at most
_KR_BYTES = 8192            # factor (KR or F) row bytes a stage holds at most
_ACC_BYTES = 256            # accumulators a thread keeps (64 registers)
SMEM_MAX = 232448           # 227 KB of shared memory a block can use

_LIB = None


def acc_size(itemsize: int) -> int:
    """Bytes of an accumulator (and of a factor and output element) for an
    X of `itemsize` bytes: float32 for 2- and 4-byte X, float64 for 8."""
    return max(4, itemsize)


class RowsStreamPlan(NamedTuple):
    """Launch plan of the modes-0/1 stream kernel (mttkrp3_rows_stream in
    csrc/mttkrp3.cu).  o is the output axis (i in mode 0, j in mode 1) and
    s the walked axis (j, i).  o is cut into tiles of ob rows, s into ns
    ranges of per rows and k into ktiles tiles of tk columns; a unit is one
    (range, o tile) pair, range-major.  Block (b, t) of an (nblk, ktiles)
    grid walks units b, b + nblk, ... of k tile t in turn,
    streaming each unit's stages of stage_rows walked rows through a ring
    of `stages` slots, and writes partial (range, k tile) of its o rows."""
    mode: int        # 0 or 1
    rm: int          # rank padded to a register bucket
    kpt: int         # consecutive k a thread owns (1, 2 or 4)
    copy: int        # X: 0 bulk copies (TMA), ENVELOPE_COPY (bulk copies
    #                  of each run's 16-byte-aligned envelope), 16/8/4 bytes
    #                  a cp.async, or PLAIN_COPY
    fcopy: int       # F rows: 0 one bulk copy a stage, else bytes a cp.async
    kthreads: int    # threads along k (a power of two)
    ob: int          # output rows a tile holds (ob * kthreads <= 256)
    tk: int          # columns of X a k tile holds
    ktiles: int      # k tiles
    ns: int          # ranges of the walked axis
    per: int         # walked rows a range holds
    nblk: int        # blocks along the units
    stage_rows: int  # walked rows a stage holds
    stages: int      # slots of the ring
    smem: int        # dynamic shared memory of a block, bytes

    @property
    def threads(self) -> int:
        """Consumer threads (the block has one producer warp more)."""
        return 32 * math.ceil(self.ob * self.kthreads / 32)

    @property
    def nsplit(self) -> int:
        """Partials, one a (range, k tile); reduce_splits sums them."""
        return self.ns * self.ktiles

    def partial_share(self, shape: tuple[int, int, int], R: int) -> float:
        """Bytes of the split partials (written once, read once) over the
        bytes of X, for an X and partials of one element size."""
        I, J, K = shape
        O = shape[self.mode]
        return 2 * self.nsplit * O * R / (I * J * K) if self.nsplit > 1 else 0.0


class StreamPlan(NamedTuple):
    """Launch plan of the mode-2 stream kernel (mttkrp3_mode2_stream in
    csrc/mttkrp3.cu).  The I*J rows of X are cut into stages of stage_rows
    rows; block (b, t) of an (nsplit, ktiles) grid owns stages
    b * spb .. (b + 1) * spb - 1 and columns t * tk .. (t + 1) * tk - 1 of
    k, and streams them through a ring of `stages` slots."""
    rm: int          # rank padded to a register bucket
    kpt: int         # consecutive k a thread owns (1, 2 or 4)
    copy: int        # X: 0 bulk copies (TMA), 16/8/4 bytes a cp.async, or
    #                  PLAIN_COPY
    abw: int         # A and B rows: 0 bulk copies, else bytes a cp.async
    kthreads: int    # threads along k (a multiple of 32)
    phases: int      # row phases (kthreads * phases consumer threads)
    tk: int          # columns of X a k tile holds
    ktiles: int      # k tiles
    nsplit: int      # row ranges, one partial each
    spb: int         # stages a range holds
    stage_rows: int  # rows a stage holds
    stages: int      # slots of the ring
    smem: int        # dynamic shared memory of a block, bytes

    @property
    def threads(self) -> int:
        """Consumer threads (the block has one producer warp more)."""
        return self.kthreads * self.phases

    def partial_share(self, shape: tuple[int, int, int], R: int) -> float:
        """Bytes of the split partials (written once, read once) over the
        bytes of X, for an X and partials of one element size."""
        I, J, _ = shape
        return 2 * self.nsplit * R / (I * J) if self.nsplit > 1 else 0.0


def _splits(n: int, want: int) -> tuple[int, int]:
    """(splits, rows per split) covering n rows with about `want` splits and
    no empty split."""
    want = max(1, min(n, want))
    per = math.ceil(n / want)
    return math.ceil(n / per), per


def column_blocks(R: int) -> list[tuple[int, int]]:
    """Column slices [a, b) of at most R_MAX that cover R in order: the
    kernel runs once a slice, since MTTKRP is columnwise independent."""
    return [(a, min(a + R_MAX, R)) for a in range(0, R, R_MAX)]


def _widest(itemsize: int, *multiples: int) -> int | None:
    """The widest copy (16, 8 or 4 bytes, at least one element) that
    divides every one of `multiples`."""
    return next((w for w in (16, 8, 4) if w >= itemsize
                 and all(m % w == 0 for m in multiples)), None)


def _rm(R: int) -> int:
    return next(b for b in _RM_BUCKETS if b >= R)


def _k_tiles(K: int, rm: int, itemsize: int) -> tuple[int, int, int]:
    """(KPT, tk, ktiles) of both stream kernels: KPT is the widest that
    keeps one read of X within 16 bytes, 64 accumulator registers, vector
    reads aligned (K % KPT == 0) and a warp busy; k is tiled only past the
    block's threads."""
    ts = acc_size(itemsize)
    kpt = next(p for p in (4, 2, 1)
               if p == 1 or (p * itemsize <= 16 and p * rm * ts <= _ACC_BYTES
                             and K % p == 0 and K >= 32 * p))
    tk = min(K, STREAM_THREADS * kpt)
    ktiles = math.ceil(K / tk)
    if ktiles > _GRID_YZ_MAX:
        raise ValueError(f"mttkrp3: K={K} needs more than {_GRID_YZ_MAX} "
                         f"k tiles")
    return kpt, tk, ktiles


def _copy_routes(K: int, tk: int, R: int, itemsize: int, x_align: int,
                 f_align: int) -> tuple[int, int]:
    """The widest copy of X (16, 8 or 4 bytes, or PLAIN_COPY for a 16-bit
    X on 2 bytes) whose every row and k tile start is aligned to it, and
    of the factor rows; then 16 bytes becomes 0, a bulk copy."""
    ts = acc_size(itemsize)
    if x_align < itemsize or f_align < ts:
        raise ValueError(f"mttkrp3: a data pointer is aligned to "
                         f"{min(x_align, f_align)} bytes, below its element")
    copy = _widest(itemsize, K * itemsize, tk * itemsize, x_align) or PLAIN_COPY
    fw = _widest(ts, R * ts, f_align)
    return (0 if copy == 16 else copy), (0 if fw == 16 else fw)


def stream_smem(stages: int, stage_rows: int, tk: int, rm: int,
                kthreads: int, phases: int, R: int, itemsize: int) -> int:
    """Dynamic shared memory of the stream kernel (StreamSmem in
    csrc/mttkrp3.cu) for an X of `itemsize` bytes: the ring of X, the ring
    of A/B rows and each consumer warp's KR rows, or the phase sums that
    reuse them, then a full and an empty mbarrier a slot."""
    ts = acc_size(itemsize)
    ring = -(-stages * stage_rows * tk * itemsize // 16) * 16
    rows_w = -(-stage_rows // phases)
    body = ring + (stages * (2 * stage_rows + 1)
                   + kthreads * phases // 32 * rows_w) * rm * ts
    red = phases * R * (tk + 16 // ts) * ts
    return -(-max(body, red) // 16) * 16 + 16 * stages


def rows_smem(mode: int, stages: int, stage_rows: int, ob: int, tk: int,
              rm: int, threads: int, itemsize: int, copy: int) -> int:
    """Dynamic shared memory of the rows-stream kernel (RowsSmem in
    csrc/mttkrp3.cu) for an X of `itemsize` bytes: the ring of X (in mode 0
    each output row's run padded by 16 bytes; on the envelope route each
    run on 16 bytes and 16 bytes more), the ring of F rows and the C tile at
    pitch rm, a sum a consumer warp, then a full and an empty mbarrier a
    slot."""
    ts = acc_size(itemsize)
    pad = 16 // itemsize
    if copy == ENVELOPE_COPY:
        opitch = -(-stage_rows * tk // pad) * pad + 2 * pad
        mpitch = -(-ob * tk // pad) * pad + pad
    else:
        opitch, mpitch = stage_rows * tk + pad, ob * tk
    xstage = ob * opitch if mode == 0 else stage_rows * mpitch
    f = -(-stages * xstage * itemsize // 16) * 16
    red = f + (stages * stage_rows + tk) * rm * ts
    return -(-(red + threads // 32 * rm * ts) // 16) * 16 + 16 * stages


def _plan_rows(shape: tuple[int, int, int], mode: int, R: int, itemsize: int,
               sms: int, x_align: int, f_align: int) -> RowsStreamPlan:
    I, J, K = shape
    O, Sn = (I, J) if mode == 0 else (J, I)
    rm = _rm(R)
    ts = acc_size(itemsize)
    kpt, tk, ktiles = _k_tiles(K, rm, itemsize)
    kthreads = 1 << (math.ceil(tk / kpt) - 1).bit_length()
    # a tile of output rows fills the block's 256 consumer threads
    ob = min(STREAM_THREADS // kthreads, O)
    n_ot = math.ceil(O / ob)
    # split the walked axis only where the o tiles leave SMs idle
    ns, per = _splits(Sn, max(1, sms // (n_ot * ktiles)))
    copy, fw = _copy_routes(K, tk, R, itemsize, x_align, f_align)
    if copy != 0 and ktiles == 1:
        # rows off 16 bytes: a run is one bulk copy of its envelope
        copy = ENVELOPE_COPY
    # F rows: one bulk copy a stage where they are not padded to rm
    fcopy = 16 if fw == 0 and R < rm else fw
    stage_rows = max(1, min(_STAGE_BYTES // (ob * tk * itemsize),
                            _KR_BYTES // (rm * ts), per))
    # units dealt to the blocks in turn, at most one block an SM
    nblk = min(ns * n_ot, max(1, sms // ktiles))
    threads = 32 * math.ceil(ob * kthreads / 32)
    smem = rows_smem(mode, STREAM_STAGES, stage_rows, ob, tk, rm, threads,
                     itemsize, copy)
    if smem > SMEM_MAX:
        raise ValueError(f"mttkrp3: the mode-{mode} plan needs {smem} bytes "
                         f"of shared memory for {shape}")
    return RowsStreamPlan(mode, rm, kpt, copy, fcopy, kthreads, ob, tk, ktiles,
                          ns, per, nblk, stage_rows, STREAM_STAGES, smem)


def _plan_stream(shape: tuple[int, int, int], rm: int, R: int, itemsize: int,
                 sms: int, x_align: int, f_align: int) -> StreamPlan:
    I, J, K = shape
    ts = acc_size(itemsize)
    kpt, tk, ktiles = _k_tiles(K, rm, itemsize)
    kthreads = 32 * math.ceil(math.ceil(tk / kpt) / 32)
    phases = STREAM_THREADS // kthreads
    copy, abw = _copy_routes(K, tk, R, itemsize, x_align, f_align)
    stage_rows = max(1, min(_STAGE_BYTES // (tk * itemsize),
                            _KR_BYTES // (rm * ts)))
    nsplit, spb = _splits(math.ceil(I * J / stage_rows), max(1, sms // ktiles))
    smem = stream_smem(STREAM_STAGES, stage_rows, tk, rm, kthreads, phases, R,
                       itemsize)
    if smem > SMEM_MAX:
        raise ValueError(f"mttkrp3: the mode-2 plan needs {smem} bytes of "
                         f"shared memory for {shape}")
    return StreamPlan(rm, kpt, copy, abw, kthreads, phases, tk, ktiles, nsplit,
                      spb, stage_rows, STREAM_STAGES, smem)


def _check_plan_args(shape, R: int, mode: int) -> None:
    if min(shape) < 1:
        raise ValueError(f"mttkrp3 needs I, J, K >= 1, got {shape}")
    if not 1 <= R <= R_MAX:
        raise ValueError(f"mttkrp3 takes 1 <= R <= {R_MAX}, got R={R}")
    if mode not in (0, 1, 2):
        raise ValueError(f"mttkrp3 mode must be 0, 1 or 2, got {mode}")


@functools.lru_cache(maxsize=256)
def plan_mttkrp3(shape: tuple[int, int, int], R: int, mode: int,
                 itemsize: int, sms: int, x_align: int = 16,
                 f_align: int = 16) -> RowsStreamPlan | StreamPlan:
    """Launch plan for an (I, J, K) tensor of `itemsize`-byte elements at
    rank R on a card with `sms` streaming multiprocessors; raises on what
    the kernel does not take.

    Modes 0 and 1 take the rows-stream kernel (RowsStreamPlan), mode 2 the
    stream kernel (StreamPlan).  x_align and f_align are the byte
    alignments of the data pointers of X and of the factors read; the
    copies follow them."""
    _check_plan_args(shape, R, mode)
    if mode == 2:
        return _plan_stream(shape, _rm(R), R, itemsize, sms, x_align, f_align)
    return _plan_rows(shape, mode, R, itemsize, sms, x_align, f_align)


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
        # (ints before the five pointers, ints after them), then the stream
        for name, head, tail in (("mttkrp3_rows_run", 3, 17),
                                 ("mttkrp3_stream_run", 3, 15)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_int] * head + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * tail + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _align(ptr: int) -> int:
    """Largest power of two up to 16 that divides ptr."""
    return min(16, ptr & -ptr) if ptr else 16


def kernel_operands(X: torch.Tensor, factors, mode: int):
    """Check what the kernel takes and return (factors in the kernel's
    accumulator dtype, R): a 3-way X in KERNEL_DTYPES, contiguous, and
    contiguous (X.shape[n], R) factors on X's device in X.dtype or
    promote(X.dtype, float32) (factors[mode] is not read).  A 16-bit
    factor is widened to float32 here (a copy of a small matrix); X is
    never copied.  Raises ValueError on anything else."""
    if X.dim() != 3 or len(factors) != 3:
        raise ValueError(f"mttkrp3 takes a 3-way tensor and 3 factors, got "
                         f"X.dim()={X.dim()} and {len(factors)} factors")
    if X.dtype not in DTYPE_CODES:
        raise ValueError(f"mttkrp3 takes X in float16, bfloat16, float32 or "
                         f"float64, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("mttkrp3 takes a contiguous X (it never copies X)")
    acc = torch.promote_types(X.dtype, torch.float32)
    ref = factors[(mode + 1) % 3]
    R = ref.shape[1] if ref.dim() == 2 else -1
    out = list(factors)
    for n, f in enumerate(factors):
        if n == mode:
            continue
        if f.device != X.device or f.dtype not in (X.dtype, acc):
            raise ValueError(f"mttkrp3: factor {n} is {f.dtype} on {f.device}, "
                             f"X is {X.dtype} on {X.device}")
        if f.dim() != 2 or f.shape != (X.shape[n], R) or not f.is_contiguous():
            raise ValueError(f"mttkrp3: factor {n} must be a contiguous "
                             f"({X.shape[n]}, {R}) matrix, got {tuple(f.shape)}")
        out[n] = f.to(acc)
    return out, R


def _launch(X: torch.Tensor, factors, mode: int,
            plan: RowsStreamPlan | StreamPlan) -> torch.Tensor:
    """Run the kernel of `plan` on checked operands (kernel_operands) with
    R <= R_MAX, and count the launch in mttkrp3.launches."""
    A, B, C = factors
    R = factors[(mode + 1) % 3].shape[1]
    I, J, K = X.shape
    acc = torch.promote_types(X.dtype, torch.float32)
    out = torch.empty((X.shape[mode], R), dtype=acc, device=X.device)
    part = (torch.empty((plan.nsplit, X.shape[mode], R), dtype=acc,
                        device=X.device) if plan.nsplit > 1 else out)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    code = DTYPE_CODES[X.dtype]
    if isinstance(plan, StreamPlan):
        err = _lib().mttkrp3_stream_run(
            code, plan.rm, plan.kpt, X.data_ptr(), A.data_ptr(), B.data_ptr(),
            part.data_ptr(), out.data_ptr(), I, J, K, R, plan.tk,
            plan.kthreads, plan.phases, plan.nsplit, plan.ktiles, plan.spb,
            plan.stage_rows, plan.stages, plan.copy, plan.abw, plan.smem,
            stream)
    else:
        F = (B, A)[mode]
        err = _lib().mttkrp3_rows_run(
            code, plan.rm, plan.kpt, X.data_ptr(), F.data_ptr(), C.data_ptr(),
            part.data_ptr(), out.data_ptr(), mode, I, J, K, R, plan.ob,
            plan.kthreads, plan.tk, plan.ktiles, plan.ns, plan.per, plan.nblk,
            plan.stage_rows, plan.stages, plan.copy, plan.fcopy, plan.smem,
            stream)
    if err != 0:
        raise RuntimeError(f"mttkrp3 launch failed: cudaError {err} "
                           f"(shape {tuple(X.shape)}, {X.dtype}, R={R}, "
                           f"mode={mode}, {plan})")
    mttkrp3.launches += 1
    return out


def _run_planned(X: torch.Tensor, facs, mode: int) -> torch.Tensor:
    R = facs[(mode + 1) % 3].shape[1]
    f_align = min(_align(f.data_ptr()) for n, f in enumerate(facs) if n != mode)
    plan = plan_mttkrp3(tuple(X.shape), R, mode, X.element_size(),
                        _sms(X.device), _align(X.data_ptr()), f_align)
    return _launch(X, facs, mode, plan)


def mttkrp3(X: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """Mode-`mode` MTTKRP of a dense (I, J, K) tensor; factors (A, B, C) with
    shapes (I, R), (J, R), (K, R) (factors[mode] is not read).  Returns
    (X.shape[mode], R) in promote(X.dtype, float32).

    A CUDA tensor launches the hand-written kernel (and counts the launch in
    mttkrp3.launches) or raises (kernel_operands says what it takes); R >
    R_MAX runs it once a column block of column_blocks(R) and counts each
    launch.  A CPU tensor takes mttkrp3_reference."""
    if X.device.type == "cpu":
        return mttkrp3_reference(X, factors, mode)
    if X.device.type != "cuda":
        raise ValueError(f"mttkrp3: unsupported device {X.device}")
    facs, R = kernel_operands(X, factors, mode)
    if R <= R_MAX:
        return _run_planned(X, facs, mode)
    return torch.cat([
        _run_planned(X, [f if n == mode else f[:, a:b].contiguous()
                         for n, f in enumerate(facs)], mode)
        for a, b in column_blocks(R)], dim=1)


mttkrp3.launches = 0

