"""Hand-written Hopper kernels for the sequential proxes (csrc/prox_seq.cu,
csrc/t_smooth.cu):

  project_isotonic_cols (kernel A)  non-decreasing, non-increasing and
      unimodal (optionally non-negative) projections; replaces the lax
      loops of matlab_code_tpu/ops/isotonic.py (no pallas_call there)
  prox_tv_cols (kernel B)  the exact TV prox, Condat's algorithm;
      replaces the lax loop of matlab_code_tpu/ops/tv.py
  t_smooth_cols (kernel C)  the tPARAFAC2 temporal-smoothness prox, a
      Thomas solve over the K slices; replaces the lax.scans of
      matlab_code_tpu/ops/prox.py:144-188

Kernels A and B take a contiguous (n, R) float32 or float64 CUDA matrix, or
a (K, n, R) stack of PARAFAC2 slices (K R columns; kernel B with one lam a
slice), and return a new one, walking each column's recurrence in float64
in the order of the plain versions (ops/isotonic.columns_reference,
ops/tv.columns_reference).  Three routes, chosen here from n, the column
count K R and the dtype before the launch (plan_isotonic, plan_tv):

  "shared"  a block of THREADS threads a column (kernel A: a scan side; a
            unimodal column is a cluster of two blocks), one thread walking
            and all staging, searching the unimodal peak and writing, the
            state in dynamic shared memory, as far as a block's 227 KB;
  "global"  the same for longer columns, the state in the block's slice of
            a workspace in device memory allocated here;
  "lanes"   stacks of many short columns: a thread walks a column (a scan
            side), a warp takes 32 adjacent columns, the lanes' state
            interleaved.  It alone takes a ragged stack (`sizes`, the J_k of
            padded slices), in one launch.

Kernel C takes a contiguous (K, J, R) stack and rho (K,) on the card and
computes in the stack's dtype, the plain version's bits
(ops/prox.t_smoothness_reference), on one of two routes chosen before the
launch (plan_t_smooth): "staged", a tile of elements over all K slices in
shared memory, or "stream", for longer K and where the staged grid would
take a second wave, r' kept in the output.  On both one warp of a block
walks the scalar recurrence and publishes it in chunks of 32 steps while
the walkers follow, and the back substitution divides through the
reciprocal of d'_k with two fma corrections (csrc/t_smooth.cu).
_t_smooth_phase and _t_smooth_div run the source's test-only entries: the
staged route's phases alone, and the division step beside the full
division.

A build or launch error raises on every route; nothing falls back to the
plain version.  Each launch is counted in the wrapper's `launches` and in
its route's entry of `route_launches`.  Nothing is built at import: the
first call builds the library (ops/_build.py).
"""
from __future__ import annotations

import ctypes

import torch

_LIB = None
_LIB_C = None
KERNEL_DTYPES = (torch.float32, torch.float64)
SHARED, GLOBAL, LANES = "shared", "global", "lanes"
STAGED, STREAM = "staged", "stream"     # kernel C's routes
T_TILE = 32              # kernel C's staged route: elements a block
T_CHUNK = 32             # kernel C: recurrence steps a published chunk (kChunk)
THREADS = 256            # threads a block (kThreads)
LANE_COLS = 32           # columns a warp of the lanes route (kLanes)
# The lanes route from this many columns (K R) on.  A warp of the lanes
# route walks its 32 columns 1.8-3.4x slower than a block walks one (the
# slowest lane's merges, the state in device memory), so it wins only
# where the block routes run in waves: at n = 256, R = 32 in float32 on an
# H100 (utils/time_prox_seq.py --crossover, in turns) the lanes route
# passes the block route between 768 and 1,056 columns for kernel A
# unimodal and kernel B, and between 1,056 and 1,536 for A non-decreasing.
LANES_MIN_COLS = 1024
# dynamic shared memory a block of the shared route may take: the 227 KB
# (232,448 bytes) a Hopper block may opt into, less 1 KB for the kernels'
# static shared memory
SMEM_LIMIT = 232448 - 1024


def _lib():
    global _LIB
    if _LIB is None:
        from matlab_code_tpu_torch.ops._build import load_library
        lib = load_library("prox_seq", ["prox_seq.cu"])
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.isotonic_run.argtypes = [i, i, i, p, p, i, i, i, l, p, l, p]
        lib.tv_run.argtypes = [i, p, p, i, i, i, p, l, p, l, p]
        lib.isotonic_lanes_run.argtypes = [i, i, i, p, p, i, i, i, p, p, l, p]
        lib.tv_lanes_run.argtypes = [i, p, p, i, i, i, p, p, l, p, l, p]
        for f in (lib.isotonic_run, lib.tv_run, lib.isotonic_lanes_run,
                  lib.tv_lanes_run):
            f.restype = i
        _LIB = lib
    return _LIB


def _lib_c():
    global _LIB_C
    if _LIB_C is None:
        from matlab_code_tpu_torch.ops._build import load_library
        lib = load_library("t_smooth", ["t_smooth.cu"])
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        d = ctypes.c_double
        lib.t_smooth_run.argtypes = [i, i, p, p, p, i, l, d, l, p]
        lib.t_smooth_phase_run.argtypes = [i, i, p, p, p, p, p, i, l, d, l, p]
        lib.t_smooth_div_run.argtypes = [i, p, p, p, p, l, p]
        for f in (lib.t_smooth_run, lib.t_smooth_phase_run,
                  lib.t_smooth_div_run):
            f.restype = i
        _LIB_C = lib
    return _LIB_C


def _itemsize(dtype: torch.dtype) -> int:
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"the sequential-prox kernels take float32 or float64, "
                         f"got {dtype}")
    return torch.empty((), dtype=dtype).element_size()


def _route(state_bytes: int) -> str:
    return SHARED if state_bytes <= SMEM_LIMIT else GLOBAL


def plan_isotonic(n: int, R: int, dtype: torch.dtype, K: int = 1
                  ) -> tuple[str, int]:
    """(route, bytes of state a walker) of kernel A on an (n, R) matrix or a
    (K, n, R) stack.  The lanes route for K R >= LANES_MIN_COLS columns: a
    lane's state in a workspace, at most 44 bytes a slot for slots 0..n
    (lanes_state_bytes); else a block's scan side, 36 bytes a slot (the
    column staged in its sumwy slots), whatever the dtype: the shared route
    while that fits a block's shared memory, the global route after."""
    _itemsize(dtype)
    if n < 1 or R < 1 or K < 1:
        raise ValueError(f"kernel A takes n, R >= 1 and K >= 1, got ({n}, {R}, {K})")
    if K * R >= LANES_MIN_COLS:
        return LANES, 44 * (n + 1)
    state = 36 * (n + 1)
    return _route(state), state


def plan_tv(n: int, R: int, dtype: torch.dtype, K: int = 1
            ) -> tuple[str, int]:
    """(route, bytes of state a walker) of kernel B on an (n, R) matrix or a
    (K, n, R) stack: the lanes route for K R >= LANES_MIN_COLS columns, a
    lane's column in the storage type (itemsize n bytes); else a block's
    column as doubles and the output in the storage type, (8 + itemsize)
    bytes a row, on the shared route while that fits, the global route
    after."""
    item = _itemsize(dtype)
    if n < 1 or R < 1 or K < 1:
        raise ValueError(f"kernel B takes n, R >= 1 and K >= 1, got ({n}, {R}, {K})")
    if K * R >= LANES_MIN_COLS:
        return LANES, item * n
    state = (8 + item) * n
    return _route(state), state


def workspace_stride(state_bytes: int) -> int:
    """Bytes of a block's slice of the global route's workspace: its state
    rounded up to 128 bytes, a cache line, so no two blocks share one."""
    return -(-state_bytes // 128) * 128


def t_smooth_smem(route: str, K: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory a block of kernel C's `route` takes on K
    slices: on the staged route two one-shot mbarriers (the staging's and
    the recurrence's) a published chunk of the recurrence, {rho_k, m_k,
    d'_k, y_k} a slice and the tile of T_TILE elements a slice; on the
    stream route d'_k and m_k (y_k after the forward walk) a slice, its
    count of published chunks being a static 4 bytes."""
    item = _itemsize(dtype)
    if route == STAGED:
        return 16 * -(-K // T_CHUNK) + (4 + T_TILE) * K * item
    return 2 * K * item


# shared memory of an SM that its blocks share, and what each block costs
# beyond its own (Hopper: 228 KB; 1 KB a block is the system's)
SMEM_SM = 233472
SMEM_BLOCK_RESERVED = 1024


def plan_t_smooth(K: int, E: int, dtype: torch.dtype, sms: int = 132
                  ) -> tuple[str, int]:
    """(route, bytes of shared memory a block) of kernel C on K slices of E
    elements on a card of `sms` SMs (t_smooth_smem).  The "staged" route
    while its (4 + T_TILE) K values and chunk barriers fit a block (K <=
    1601 in float32, 802 in float64) and its ceil(E / T_TILE) blocks run
    in one wave (as many as the SMs' shared memory holds at once: each
    wave walks the whole recurrence again); else the "stream" route (2 K
    values a block; r' kept in the output), which holds 64 elements a
    block in a few KB.  ValueError past even that (K > 14464 in float64,
    28928 in float32).  At the PAR2 shape (512, 256, 32) float32 stages
    (256 blocks of 74 KB, three an SM) and float64 streams (256 blocks of
    148 KB would take two waves).  The one-wave rule as measured in turns
    on an H100 80GB HBM3 at 700 W (utils/time_prox_seq.py --c-stacks):
    float64 at (512, 256, 32) 121.3 us staged in two waves, 77.6 streamed;
    float32 at (512, 512, 32), 512 blocks past a wave's 396, 76.7 us
    staged, 70.8 streamed; float32 at the PAR2 shape 39.6 staged, 55.9
    streamed."""
    _itemsize(dtype)
    if K < 1 or E < 1:
        raise ValueError(f"kernel C takes K, J R >= 1, got ({K}, {E})")
    staged = t_smooth_smem(STAGED, K, dtype)
    per_sm = SMEM_SM // (staged + SMEM_BLOCK_RESERVED)
    if staged <= SMEM_LIMIT and -(-E // T_TILE) <= sms * per_sm:
        return STAGED, staged
    stream = t_smooth_smem(STREAM, K, dtype)
    if stream > SMEM_LIMIT:
        raise ValueError(f"kernel C keeps 2 K values in shared memory: K = {K} "
                         f"needs {stream} bytes, a block has {SMEM_LIMIT}")
    return STREAM, stream


def _check(X: torch.Tensor, name: str, dims=(2, 3)) -> None:
    if X.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor, got one on {X.device}")
    if X.dim() not in dims or X.dtype not in KERNEL_DTYPES \
            or not X.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (n, R) matrix or (K, n, R) "
                         f"stack, float32 or float64, got {tuple(X.shape)} "
                         f"{X.dtype}, contiguous {X.is_contiguous()}")


def _stream(X: torch.Tensor) -> int:
    return torch.cuda.current_stream(X.device).cuda_stream


def _run(kernel, X: torch.Tensor, route: str, state: int, blocks: int,
         args: tuple) -> int:
    """Launch `kernel` (a C entry of a block route) on `route`: with a
    block's `state` bytes (plan_isotonic's / plan_tv's block state) of
    shared memory a block, or a workspace of `blocks` slices allocated
    here.  args: the entry's arguments before (smem, ws,
    stride, stream).  Returns the launch's CUDA error."""
    if route == SHARED:
        return kernel(*args, state, None, 0, _stream(X))
    stride = workspace_stride(state)
    ws = torch.empty(blocks * stride, dtype=torch.uint8, device=X.device)
    return kernel(*args, 0, ws.data_ptr(), stride, _stream(X))


def lanes_state_bytes(n: int, kind: int) -> int:
    """Bytes of a warp's state in kernel A's lanes route (lanes_state_bytes
    in csrc/prox_seq.cu): slots 0..n of 32 lanes, 20 bytes a slot a lane
    for kinds 0 and 1 (sumwy, idxr, and the level just before the slot's
    set), 44 for the unimodal kind (with sumwy2, err, and the err just
    before the set)."""
    return (44 if kind == 2 else 20) * (n + 1) * LANE_COLS


_SIZES: dict = {}


def _sizes_on(sizes, K: int, n: int, device) -> torch.Tensor:
    """The J_k of a ragged (K, n, R) stack as K int32 on the device, checked
    (1 <= J_k <= n) and kept for the calls that follow with the same
    sizes (one copy to the card a fit)."""
    key = (tuple(int(J) for J in sizes), str(device))
    if key not in _SIZES:
        if len(key[0]) != K or not all(1 <= J <= n for J in key[0]):
            raise ValueError(f"ragged sizes: {K} slice lengths in 1..{n} "
                             f"expected, got {key[0]}")
        if len(_SIZES) >= 16:
            _SIZES.clear()
        _SIZES[key] = torch.tensor(key[0], dtype=torch.int32, device=device)
    return _SIZES[key]


def _stack_dims(X: torch.Tensor, sizes) -> tuple[int, int, int]:
    n, R = X.shape[-2:]
    K = X.shape[0] if X.dim() == 3 else 1
    if sizes is not None and X.dim() != 3:
        raise ValueError("ragged sizes take a (K, n, R) stack, got "
                         f"{tuple(X.shape)}")
    return K, n, R


def _launched(fn, route: str, err: int, X: torch.Tensor) -> None:
    """Raise on a launch's CUDA error, else count the launch on `route`."""
    if err != 0:
        raise RuntimeError(f"{fn.__name__} ({route} route) launch failed: "
                           f"cudaError {err} ({'x'.join(map(str, X.shape))} "
                           f"{X.dtype})")
    fn.launches += 1
    fn.route_launches[route] += 1


def project_isotonic_cols(X: torch.Tensor, kind: int, nonneg: bool = False,
                          sizes=None) -> torch.Tensor:
    """Kernel A on every column of X (n, R), or of every slice of X
    (K, n, R), in one launch: kind 0 non-decreasing, 1 non-increasing, 2
    unimodal (non-negative where nonneg).  sizes: the true lengths J_k of
    the slices of a padded ragged stack (the lanes route); rows J_k and
    after are written as zeros."""
    _check(X, "project_isotonic_cols")
    return _isotonic(X, kind, nonneg, sizes=sizes)


def _isotonic(X: torch.Tensor, kind: int, nonneg: bool,
              route: str | None = None, sizes=None) -> torch.Tensor:
    """Kernel A on plan_isotonic's route (LANES for a ragged stack), or on
    `route` (GLOBAL or LANES at any n: the card tests and the timing of
    the routes)."""
    K, n, R = _stack_dims(X, sizes)
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    planned = plan_isotonic(n, R, X.dtype, K)[0]
    route = route or (LANES if sizes is not None else planned)
    if sizes is not None and route != LANES:
        raise ValueError(f"a ragged stack takes the lanes route, not {route}")
    args = (int(X.dtype == torch.float64), kind, int(bool(nonneg)),
            X.data_ptr(), out.data_ptr(), K, n, R)
    if route != LANES:
        err = _run(_lib().isotonic_run, X, route, 36 * (n + 1),
                   (2 if kind == 2 else 1) * K * R, args)
    else:
        sz = _sizes_on(sizes, K, n, X.device) if sizes is not None else None
        warps = (2 if kind == 2 else 1) * -(-K * R // LANE_COLS)
        stride = workspace_stride(lanes_state_bytes(n, kind))
        ws = torch.empty(warps * stride, dtype=torch.uint8, device=X.device)
        err = _lib().isotonic_lanes_run(
            *args, None if sz is None else sz.data_ptr(), ws.data_ptr(),
            stride, _stream(X))
    _launched(project_isotonic_cols, route, err, X)
    return out


project_isotonic_cols.launches = 0
project_isotonic_cols.route_launches = {SHARED: 0, GLOBAL: 0, LANES: 0}


def prox_tv_cols(X: torch.Tensor, lam, sizes=None) -> torch.Tensor:
    """Kernel B on every column of X (n, R) with strength lam (a number or
    a 0-d tensor), or on every slice of X (K, n, R) in one launch, slice k
    with lam[k] (a tensor of K values, or one value for all).  A CUDA lam
    is read by the kernel, never by the host.  sizes: the true lengths J_k
    of a padded ragged stack (the lanes route), rows J_k and after zero."""
    _check(X, "prox_tv_cols")
    return _tv(X, lam, sizes=sizes)


def _tv(X: torch.Tensor, lam, route: str | None = None, sizes=None,
        in_shared: bool | None = None) -> torch.Tensor:
    """Kernel B on plan_tv's route (LANES for a ragged stack), or on
    `route` (GLOBAL or LANES at any n).  On the lanes route a warp's
    columns are staged in shared memory where they fit (32 n itemsize
    bytes: n up to 1808 in float32, 904 in float64), else in a workspace
    in device memory; in_shared names one (the card tests and the timing
    of the two)."""
    K, n, R = _stack_dims(X, sizes)
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    planned = plan_tv(n, R, X.dtype, K)[0]
    route = route or (LANES if sizes is not None else planned)
    if sizes is not None and route != LANES:
        raise ValueError(f"a ragged stack takes the lanes route, not {route}")
    lam_t = torch.as_tensor(lam, dtype=torch.float64).to(X.device).reshape(-1)
    if lam_t.numel() not in (1, K):
        raise ValueError(f"prox_tv_cols: {lam_t.numel()} lam values for {K} "
                         "slices")
    lam_t = lam_t.expand(K).contiguous()
    args = (int(X.dtype == torch.float64), X.data_ptr(), out.data_ptr(), K, n,
            R)
    if route != LANES:
        err = _run(_lib().tv_run, X, route, (8 + _itemsize(X.dtype)) * n,
                   K * R, args + (lam_t.data_ptr(),))
    else:
        sz = _sizes_on(sizes, K, n, X.device) if sizes is not None else None
        args += (None if sz is None else sz.data_ptr(), lam_t.data_ptr())
        warp_bytes = _itemsize(X.dtype) * n * LANE_COLS
        if in_shared is None:
            in_shared = warp_bytes <= SMEM_LIMIT
        if in_shared:
            err = _lib().tv_lanes_run(*args, warp_bytes, None, 0, _stream(X))
        else:
            stride = workspace_stride(warp_bytes)
            ws = torch.empty(-(-K * R // LANE_COLS) * stride,
                             dtype=torch.uint8, device=X.device)
            err = _lib().tv_lanes_run(*args, 0, ws.data_ptr(), stride,
                                      _stream(X))
    _launched(prox_tv_cols, route, err, X)
    return out


prox_tv_cols.launches = 0
prox_tv_cols.route_launches = {SHARED: 0, GLOBAL: 0, LANES: 0}


def t_smooth_cols(Bs: torch.Tensor, rho, eta: float) -> torch.Tensor:
    """Kernel C: the tPARAFAC2 prox of a contiguous (K, J, R) CUDA stack,
    rho (K,) (a tensor, on the card or moved there; never read by the
    host), eta a number."""
    _check(Bs, "t_smooth_cols", dims=(3,))
    return _t_smooth(Bs, rho, eta)


def _t_smooth(Bs: torch.Tensor, rho, eta: float,
              route: str | None = None) -> torch.Tensor:
    """Kernel C on plan_t_smooth's route, or on `route` (STREAM at any K:
    the card tests and the timing of the two routes)."""
    K = Bs.shape[0]
    E = Bs.numel() // K if K else 0
    out = torch.empty_like(Bs)
    if Bs.numel() == 0:
        return out
    if route is None:
        from matlab_code_tpu_torch.ops.mttkrp_cuda import _sms
        route = plan_t_smooth(K, E, Bs.dtype, _sms(Bs.device))[0]
    smem = t_smooth_smem(route, K, Bs.dtype)
    rho_t = _rho_on(rho, Bs)
    err = _lib_c().t_smooth_run(int(Bs.dtype == torch.float64),
                                int(route == STAGED), Bs.data_ptr(),
                                rho_t.data_ptr(), out.data_ptr(), K, E,
                                float(eta), smem, _stream(Bs))
    if err != 0:
        raise RuntimeError(f"t_smooth_cols ({route} route) launch failed: "
                           f"cudaError {err} ({'x'.join(map(str, Bs.shape))} "
                           f"{Bs.dtype})")
    t_smooth_cols.launches += 1
    t_smooth_cols.route_launches[route] += 1
    return out


def _rho_on(rho, Bs: torch.Tensor) -> torch.Tensor:
    rho_t = torch.as_tensor(rho).to(device=Bs.device, dtype=Bs.dtype).reshape(-1)
    if rho_t.numel() != Bs.shape[0]:
        raise ValueError(f"t_smooth_cols: {rho_t.numel()} rho values for "
                         f"{Bs.shape[0]} slices")
    return rho_t.contiguous()


PHASE_ALL, PHASE_RECURRENCE, PHASE_STAGING, PHASE_WALK = 0, 1, 2, 3
# the stamps of a block (kStamps in csrc/t_smooth.cu): SM clocks at the
# start, the recurrence's end, the staging's end, the forward walk's end and
# the back substitution's end, then the global timer (ns) at the start and
# at the back substitution's end
T_STAMPS = 8


def _t_smooth_phase(mode: int, Bs: torch.Tensor, rho, eta: float,
                    dbg: torch.Tensor | None, out: torch.Tensor,
                    stamps: torch.Tensor | None = None) -> None:
    """Kernel C's staged route, whole or one phase alone, on its own grid
    (the phase breakdown of utils/time_prox_seq.py --phases and
    chip_smoke.py phase 11): PHASE_ALL the whole kernel (out: the prox),
    PHASE_RECURRENCE the recurrence warps alone (block 0 writes {rho_k,
    m_k, d'_k, 0} to dbg, 4 K values of Bs's dtype; y_k is the walkers'),
    PHASE_STAGING the staging of the tiles alone, PHASE_WALK the staging
    and the walks with dbg's recurrence published at once (out: the
    prox).  stamps: an int64 CUDA tensor of T_STAMPS values a block, or
    None.  Not counted in t_smooth_cols.launches."""
    _check(Bs, "_t_smooth_phase", dims=(3,))
    K = Bs.shape[0]
    E = Bs.numel() // K
    if (dbg is None and mode != PHASE_ALL) or (dbg is not None and (
            dbg.dtype != Bs.dtype or dbg.numel() < 4 * K or not dbg.is_cuda)) \
            or out.shape != Bs.shape or out.dtype != Bs.dtype:
        raise ValueError("_t_smooth_phase: dbg takes 4 K values and out Bs's "
                         "shape, both in Bs's dtype on the card")
    if stamps is not None and (stamps.dtype != torch.int64 or not stamps.is_cuda
                               or stamps.numel() < T_STAMPS * -(-E // T_TILE)):
        raise ValueError("_t_smooth_phase: stamps takes T_STAMPS int64 a block")
    err = _lib_c().t_smooth_phase_run(
        mode, int(Bs.dtype == torch.float64), Bs.data_ptr(),
        _rho_on(rho, Bs).data_ptr(), out.data_ptr(),
        None if dbg is None else dbg.data_ptr(),
        None if stamps is None else stamps.data_ptr(), K, E, float(eta),
        t_smooth_smem(STAGED, K, Bs.dtype), _stream(Bs))
    if err != 0:
        raise RuntimeError(f"_t_smooth_phase {mode} launch failed: cudaError {err}")


def _t_smooth_div(n: torch.Tensor, d: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's back-substitution division step on the pairs (n, d) of
    two contiguous CUDA vectors of one dtype: (the step as the kernel takes
    it, from d's correctly rounded reciprocal, and the full IEEE division
    __fdiv_rn / __ddiv_rn), for the card test that holds them bit-equal."""
    _check(n, "_t_smooth_div", dims=(1,))
    if d.shape != n.shape or d.dtype != n.dtype or not d.is_cuda \
            or not d.is_contiguous():
        raise ValueError("_t_smooth_div: n and d take one shape and dtype")
    q, ref = torch.empty_like(n), torch.empty_like(n)
    err = _lib_c().t_smooth_div_run(int(n.dtype == torch.float64),
                                    n.data_ptr(), d.data_ptr(), q.data_ptr(),
                                    ref.data_ptr(), n.numel(), _stream(n))
    if err != 0:
        raise RuntimeError(f"_t_smooth_div launch failed: cudaError {err}")
    return q, ref


t_smooth_cols.launches = 0
t_smooth_cols.route_launches = {STAGED: 0, STREAM: 0}
