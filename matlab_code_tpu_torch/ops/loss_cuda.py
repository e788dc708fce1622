"""Kernel D, the hand-written Hopper loss pass (csrc/loss_fg.cu), in two
forms that share the formulas of ops/losses.py (KL, Itakura-Saito, beta
divergence).  Neither replaces a Pallas kernel: the JAX package leaves the
pass to XLA, fused inside the L-BFGS-B value and gradient
(matlab_code_tpu/models/lbfgs_bridge.py:41-49) and the objective
(matlab_code_tpu/models/objective.py:84-87).

The fused evaluation, loss_fg_mttkrp_cuda: from a dense 3-way X and its
three factors, f = sum fh(X, M) and G = the MTTKRP of gh(X, M) into mode
0, 1 or 2 (or f alone), with the CP model M formed element by element in
the kernel and never written to device memory: one launch where the
three-call evaluation (torch.einsum's M, the old pass, mttkrp3) made
three.  plan_fused lays the launch out from the shape alone, so f's and
G's bits are a function of the inputs.  loss_fg_mttkrp_cuda_starts makes
the evaluation of S starts in one launch (factors (S, n, R), X shared or
one a start), each start's f and G the bits of its own single launch.
Each call of either counts one in `loss_fg_mttkrp_cuda.launches`.

The old pass, loss_fg_cuda: (sum fh(X, M), gh(X, M)) from X and a given
M of any shape, for the datasets the fused kernel does not take (2-way,
order above 3, a block cut over a mesh); loss_fg_cuda_starts is its start
axis.  Each call of either counts one in `loss_fg_cuda.launches`.

Every entry takes contiguous float32 or float64 CUDA tensors, launches on
torch's current stream, returns f in X's dtype (summed in float64 in a
fixed order, so two calls give the same bits) and raises on anything
else, and on a build or launch error; nothing falls back to a plain
version (ops/losses.py).  Nothing is built at import: the first call
builds the library (ops/_build.py).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

_LIB = None
KERNEL_DTYPES = (torch.float32, torch.float64)
LOSS_CODES = {"KL": 0, "IS": 1, "beta": 2}   # enum Loss of csrc/loss_fg.cu
THREADS = 256           # kThreads: threads a block of the pass
BLOCKS_PER_SM = 8       # blocks of the pass an SM (2,048 threads)
# the fused evaluation (kFused* of csrc/loss_fg.cu)
FUSED_THREADS = 256
FUSED_ROWS = 8          # rows a thread takes of each chunk
FUSED_STAGE = 4         # factor-row entries a thread stages a chunk
FUSED_RMS = (4, 8, 16, 32, 48, 64)   # R padded: the kernel's instances
FUSED_SMEM_MAX = 40960  # dynamic shared memory of a block
FUSED_UNIT = 16384      # elements a block's unit aims at


def _lib():
    global _LIB
    if _LIB is None:
        from matlab_code_tpu_torch.ops._build import load_library
        lib = load_library("loss_fg", ["loss_fg.cu"])
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        d = ctypes.c_double
        lib.loss_fg_run.argtypes = [i, i, p, l, p, p, l, i, d, d, p, i, p, p]
        lib.loss_fg_run.restype = i
        lib.loss_fg_fused_run.argtypes = ([i, i, i, p, l, p, p, p]
                                          + [i] * 8 + [l] + [i] * 5
                                          + [d, d, p, p, p, p, p])
        lib.loss_fg_fused_run.restype = i
        _LIB = lib
    return _LIB


def grid_blocks(n: int, sms: int) -> int:
    """Blocks of the pass for n elements on a card of `sms` SMs: one block
    per THREADS elements, at most BLOCKS_PER_SM an SM (each thread then
    walks its elements a grid apart).  A function of n and the card only,
    so the partial sums, and f's bits, are too."""
    return max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms))


def _check_loss(who: str, loss: str, beta) -> None:
    if loss not in LOSS_CODES:
        raise ValueError(f"{who}: no kernel for loss {loss!r}")
    if loss == "beta" and beta is None:
        raise ValueError(f"{who}: the beta loss needs its beta")


def _check_operands(who: str, X: torch.Tensor, others) -> None:
    """X and each (name, tensor) of others: contiguous float32 or float64
    CUDA tensors of X's dtype on X's card."""
    for name, t in (("X", X), *others):
        if t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}, not a CUDA "
                             "card")
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{who}: {name} is {t.dtype}; the kernel takes "
                             "float32 or float64")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
        if t.dtype != X.dtype or t.device != X.device:
            raise ValueError(f"{who}: X {X.dtype} on {X.device} and {name} "
                             f"{t.dtype} on {t.device} differ")


def _check(loss: str, beta, X: torch.Tensor, M: torch.Tensor) -> None:
    _check_loss("loss_fg_cuda", loss, beta)
    _check_operands("loss_fg_cuda", X, [("M", M)])


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


# ---- the fused evaluation ---------------------------------------------------

def fused_kpt(rm: int, itemsize: int) -> int:
    """k a thread of the fused kernel owns (fused_kpt of csrc/loss_fg.cu):
    two where their C rows take at most 32 registers, else one."""
    return 2 if rm * itemsize <= 64 else 1


@dataclass(frozen=True)
class FusedPlan:
    """A launch of the fused evaluation (FusedArgs of csrc/loss_fg.cu).

    rm: R padded; kpt: k a thread; kw_log2: log2 of the threads along k
    (the other 256 / kw threads are row lanes, each taking FUSED_ROWS rows
    of a chunk); ktiles: k tiles of kw kpt; rows kind (mode 0, 1): nsplit
    ranges of `span` walked rows an output row, a unit (kt, o, range);
    stream kind (mode 2, and the f-only pass): nsplit ranges of `span`
    rows (i, j), a unit (kt, range); units: blocks a start; nslices:
    partial slices of G, each nout x R; smem: dynamic shared memory of a
    block."""
    mode: int
    rm: int
    kpt: int
    kw_log2: int
    ktiles: int
    nsplit: int
    span: int
    units: int
    nslices: int
    nout: int
    smem: int

    @property
    def chunk_rows(self) -> int:
        return (FUSED_THREADS >> self.kw_log2) * FUSED_ROWS


@functools.lru_cache(maxsize=256)
def plan_fused(shape, R: int, mode: int, itemsize: int) -> FusedPlan:
    """The fused kernel's launch for X of `shape` (I, J, K), rank R and
    output mode 0, 1 or 2 (2 also for the f-only pass), in elements of
    `itemsize` bytes: a function of these alone.  Raises where the kernel
    has no instance (R past FUSED_RMS[-1], an empty X)."""
    I, J, K = (int(n) for n in shape)
    if min(I, J, K) < 1:
        raise ValueError(f"loss_fg_mttkrp_cuda: empty X {tuple(shape)}")
    if not 1 <= R <= FUSED_RMS[-1]:
        raise ValueError(f"loss_fg_mttkrp_cuda: rank {R} (the kernel takes "
                         f"1 to {FUSED_RMS[-1]})")
    if mode not in (0, 1, 2):
        raise ValueError(f"loss_fg_mttkrp_cuda: mode {mode} of a 3-way X")
    rm = next(r for r in FUSED_RMS if r >= R)
    kpt = fused_kpt(rm, itemsize)
    rows = mode < 2
    stage_row = rm * itemsize * (2 if rows else 1)   # bytes a staged row
    # threads along k: enough for K in one tile (at most all 256), and no
    # fewer than leave a chunk's rows (two buffers of them) within
    # FUSED_SMEM_MAX and its rm-wide table within FUSED_STAGE entries a
    # thread
    kw_log2 = min(8, max(0, (-(-K // kpt) - 1).bit_length()))
    while ((FUSED_THREADS >> kw_log2) * FUSED_ROWS * 2 * stage_row
           > FUSED_SMEM_MAX or (FUSED_THREADS >> kw_log2) * FUSED_ROWS * rm
           > FUSED_THREADS * FUSED_STAGE):
        kw_log2 += 1
    nr = (FUSED_THREADS >> kw_log2) * FUSED_ROWS
    tile = kpt << kw_log2
    ktiles = -(-K // tile)
    cols = min(K, tile)
    # rows of a range: about FUSED_UNIT elements, whole chunks
    span = max(1, -(-FUSED_UNIT // (cols * nr))) * nr
    if rows:
        O, S = (I, J) if mode == 0 else (J, I)
        nsplit = -(-S // span)
        units, nslices, nout = ktiles * O * nsplit, ktiles * nsplit, O
    else:
        nsplit = -(-(I * J) // span)
        units, nslices, nout = ktiles * nsplit, nsplit, K
    smem = 2 * nr * stage_row
    if not rows:     # the row lanes' reduction: 8 x 256 elements
        smem = max(smem, 8 * FUSED_THREADS * itemsize)
    return FusedPlan(mode, rm, kpt, kw_log2, ktiles, nsplit, span, units,
                     nslices, nout, smem)


def _launch_fused(loss: str, X: torch.Tensor, factors, mode: int,
                  eps_log: float, beta, grad: bool, x_stride: int):
    """The fused kernel for S = factors[0].shape[0] starts: factors (S, n,
    R), X (I, J, K) at s x_stride.  Returns (f (S,), G (S, n_mode, R) or
    None)."""
    S, _, R = factors[0].shape
    shape = tuple(f.shape[1] for f in factors)
    item = X.element_size()
    plan = plan_fused(shape, R, mode if grad else 2, item)
    dev = X.device
    f = torch.empty((S,), dtype=X.dtype, device=dev)
    G = torch.empty((S, shape[mode], R), dtype=X.dtype, device=dev) \
        if grad else None
    gpart = torch.empty((S, plan.nslices, plan.nout * R) if grad else (1,),
                        dtype=X.dtype, device=dev)
    fpart = torch.empty((S, plan.units), dtype=torch.float64, device=dev)
    # each thread's kpt elements of a row as one vector load
    vec = shape[2] % plan.kpt == 0 and X.data_ptr() % (plan.kpt * item) == 0
    err = _lib().loss_fg_fused_run(
        int(X.dtype == torch.float64), LOSS_CODES[loss], plan.rm,
        X.data_ptr(), x_stride, *(t.data_ptr() for t in factors), *shape, R,
        plan.mode, int(grad), plan.kw_log2, plan.nsplit, plan.span,
        plan.units, plan.nslices, int(vec), plan.smem, S, float(eps_log),
        0.0 if beta is None else float(beta), gpart.data_ptr(),
        fpart.data_ptr(), 0 if G is None else G.data_ptr(), f.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"loss_fg_mttkrp_cuda ({loss}, mode {mode}) launch "
                           f"failed: cudaError {err} ({S} x {shape} R {R} "
                           f"{X.dtype}; {plan})")
    loss_fg_mttkrp_cuda.launches += 1
    return f, G


def _check_fused(loss, beta, X, factors, mode, starts: bool) -> None:
    who = "loss_fg_mttkrp_cuda" + ("_starts" if starts else "")
    _check_loss(who, loss, beta)
    if len(factors) != 3:
        raise ValueError(f"{who}: {len(factors)} factors; the kernel takes a "
                         "3-way X and its three factors")
    _check_operands(who, X, [(f"factor {d}", f) for d, f in
                             enumerate(factors)])
    lead = 1 if starts else 0
    if any(f.dim() != 2 + lead for f in factors) or \
            len({f.shape[1 + lead] for f in factors}) != 1 or \
            (starts and len({f.shape[0] for f in factors}) != 1):
        raise ValueError(f"{who}: factors of shapes "
                         f"{[tuple(f.shape) for f in factors]}")
    shape = tuple(f.shape[lead] for f in factors)
    if tuple(X.shape[-3:]) != shape or X.dim() not in (3, 3 + lead):
        raise ValueError(f"{who}: X {tuple(X.shape)} for factors of "
                         f"{shape} rows")
    if mode not in (0, 1, 2):
        raise ValueError(f"{who}: mode {mode} of a 3-way X")


def loss_fg_mttkrp_cuda(loss: str, X: torch.Tensor, factors, mode: int,
                        eps_log: float, beta: float | None = None,
                        grad: bool = True):
    """The fused evaluation: (sum fh(X, M), MTTKRP(gh(X, M), factors,
    mode)) with M = ktensor_full(factors) formed in the kernel, for loss
    'KL', 'IS' or 'beta'; X (I, J, K), factors (I, R), (J, R), (K, R).
    grad=False: (f, None), the objective's term."""
    _check_fused(loss, beta, X, factors, mode, starts=False)
    f, G = _launch_fused(loss, X, [t[None] for t in factors], mode, eps_log,
                         beta, grad, 0)
    return f[0], None if G is None else G[0]


def loss_fg_mttkrp_cuda_starts(loss: str, X: torch.Tensor, factors,
                               mode: int, eps_log: float,
                               beta: float | None = None, grad: bool = True):
    """The fused evaluation of S starts in one launch: factors (S, n, R),
    X (I, J, K) shared or (S, I, J, K) one a start.  Returns (f (S,), G
    (S, n_mode, R) or None), start s's the bits of
    loss_fg_mttkrp_cuda(loss, X[s], [F[s] for F in factors], mode, ...)."""
    _check_fused(loss, beta, X, factors, mode, starts=True)
    S = factors[0].shape[0]
    if not 1 <= S <= 65535:
        raise ValueError(f"loss_fg_mttkrp_cuda_starts: {S} starts (1 to "
                         "65535)")
    if X.dim() == 4 and X.shape[0] != S:
        raise ValueError(f"loss_fg_mttkrp_cuda_starts: X {tuple(X.shape)} "
                         f"for {S} starts")
    x_stride = X[0].numel() if X.dim() == 4 else 0
    return _launch_fused(loss, X, factors, mode, eps_log, beta, grad,
                         x_stride)


loss_fg_mttkrp_cuda.launches = 0
