"""Hand-written Hopper kernels for the sparse COO MTTKRP.

Counterpart of matlab_code_tpu/ops/sparse_pallas.py.  The kernels
(csrc/mttkrp_sparse.cu) replace the Pallas kernel `mttkrp_sparse_pallas`
(sparse_pallas.py:257-311, pallas_call at :300):

    out[i, r] = sum over the nonzeros n with idx[n, mode] = i of
                v[n] * prod over the other modes g of F_g[idx[n, g], r]

The TPU layout (128-row factor-tile buckets, 7-bit packed offsets, one-hot
matmuls fed as `passes` bf16 splits) exists for the MXU; on Hopper a lane
loads a factor entry exactly, so none of it is carried over and
AlgOptions.sparse_mttkrp / sparse_pallas_passes choose nothing here.  What
the TPU kernel did keep, factor tiles resident in fast memory, the fiber
kernel keeps in shared memory.

What bounds it on the H100: the plan stream, 12 bytes a nonzero in float32
(two int32 coordinates and the value), read once from HBM, and the factor
gathers (4R bytes a row) from the 50 MB L2.  The plan sorts the nonzeros by
the target mode's index and cuts every row into chunks of at most CHUNK
nonzeros; one warp sums a chunk into a partial row and a second pass sums
each row's partials in chunk order, so there are no atomics and repeated
calls give the same bits.  Two kernels read such a plan, and the plan names
the one it is for (choose_kernel, from the shape alone):

* "fiber" (3-way tensors whose resident factor tile fits shared memory):
  one gathered factor's column tile sits in shared memory, the nonzeros of
  a row are also sorted by the other gathered mode (the fiber mode), and
  that mode's factor row is gathered once a fiber instead of once a
  nonzero.
* "chunk" (every other order, and gathered dimensions too large for shared
  memory): both factor rows gathered from L2 for every nonzero.

See the source for the design.

build_plan(indices, values, shape, mode, rank) builds a SparsePlan with
torch ops on the data's device, once per sparsity pattern and mode.
mttkrp_sparse_cuda(plan, factors) launches the plan's kernel on a CUDA
card and raises on anything it does not take; for a plan on the CPU it
returns the plain version, mttkrp_sparse_reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

CHUNK = 256       # nonzeros per chunk: one warp each
NG_MAX = 4        # gathered modes the kernel takes (tensors of order 2 to 5)
SMEM_BYTES = 232448   # dynamic shared memory a block may use on an H100 (227 KB)
FIBER_WARPS = 32      # warps a block of the fiber kernel (kFiberWarps in the source)
FIBER_P_MAX = 16      # the fiber kernel holds P fiber rows a lane in registers

_LIB = None


class KernelChoice(NamedTuple):
    """Which kernel of csrc/mttkrp_sparse.cu a plan is for.

    variant       "fiber" or "chunk" (see the module docstring)
    lanes         P: lanes a nonzero (chunk) or columns of the resident
                  tile (fiber), 8, 16 or 32
    gather_modes  the gathered modes in the order of the plan's coords
                  columns: (fiber mode, resident mode) for "fiber",
                  ascending for "chunk"
    """
    variant: str
    lanes: int
    gather_modes: tuple


def lanes_for(R: int) -> int:
    """The smallest P of 8, 16, 32 that covers R (32 past 32)."""
    return 8 if R <= 8 else 16 if R <= 16 else 32


def choose_kernel(shape, mode: int, R: int, itemsize: int) -> KernelChoice:
    """The kernel for target mode `mode` of a tensor of dense `shape` at
    rank R with `itemsize`-byte values.  A 3-way tensor takes the fiber
    kernel with the larger gathered mode resident in shared memory (the
    later mode on a tie), at the largest P <= min(lanes_for(R),
    FIBER_P_MAX) whose tile of shape[resident] x P values fits SMEM_BYTES;
    where neither gathered mode fits at P = 8, and for any other order, the
    chunk kernel."""
    shape = tuple(int(d) for d in shape)
    gm = tuple(a for a in range(len(shape)) if a != mode)
    lanes = lanes_for(R)
    if len(gm) == 2:
        for res in sorted(gm, key=lambda g: (shape[g], g), reverse=True):
            P = min(lanes, FIBER_P_MAX)
            while P > 8 and shape[res] * P * itemsize > SMEM_BYTES:
                P //= 2
            if shape[res] * P * itemsize <= SMEM_BYTES:
                fib = gm[0] if res == gm[1] else gm[1]
                return KernelChoice("fiber", P, (fib, res))
    return KernelChoice("chunk", lanes, gm)


class SparsePlan(NamedTuple):
    """The layout of one target mode's nonzeros that the kernel reads.

    variant     "fiber" or "chunk": the kernel the plan is for
    lanes       P of that kernel (KernelChoice)
    coords      (nnz, ng) int32: the gathered modes' coordinates, in the
                order of gather_modes; nonzeros sorted stably by the target
                mode's index and, for "fiber", then by the fiber mode's
                coordinate (coords[:, 0])
    vals        (nnz,): the values in the same order
    rowptr      (D + 1,) int64: row i holds sorted nonzeros rowptr[i] ..
                rowptr[i+1]-1
    chunk_ptr   (D + 1,) int64: row i's chunks are chunk_ptr[i] ..
                chunk_ptr[i+1]-1
    chunk_start (nchunks + 1,) int64: chunk c holds sorted nonzeros
                chunk_start[c] .. chunk_start[c+1]-1, at most CHUNK
    """
    out_mode: int
    gather_modes: tuple
    shape: tuple
    variant: str
    lanes: int
    coords: torch.Tensor
    vals: torch.Tensor
    rowptr: torch.Tensor
    chunk_ptr: torch.Tensor
    chunk_start: torch.Tensor

    @property
    def out_dim(self) -> int:
        return self.shape[self.out_mode]

    @property
    def nchunks(self) -> int:
        return self.chunk_start.shape[0] - 1


def build_plan(indices: torch.Tensor, values: torch.Tensor, shape, mode: int,
               rank: int, variant: str | None = None) -> SparsePlan:
    """The kernel's layout for target mode `mode` of the COO tensor
    (indices (nnz, ndim), values (nnz,)) of dense `shape` at rank `rank`,
    built with torch ops on the data's device.  The kernel is
    choose_kernel's; variant="chunk" asks for the chunk kernel whatever the
    shape (to time it against the fiber kernel), variant="fiber" for the
    fiber kernel where the shape takes it.  Raises on coordinates outside
    `shape`."""
    shape = tuple(int(d) for d in shape)
    nd = len(shape)
    if indices.dim() != 2 or indices.shape[1] != nd:
        raise ValueError(f"build_plan: indices of shape {tuple(indices.shape)} "
                         f"for a {nd}-way tensor")
    if values.shape != (indices.shape[0],):
        raise ValueError(f"build_plan: {tuple(values.shape)} values for "
                         f"{indices.shape[0]} coordinates")
    if not 0 <= mode < nd:
        raise ValueError(f"build_plan: mode {mode} of a {nd}-way tensor")
    if rank < 1:
        raise ValueError(f"build_plan: rank must be >= 1, got {rank}")
    choice = choose_kernel(shape, mode, rank, values.element_size())
    if variant == "chunk" and choice.variant == "fiber":
        choice = KernelChoice("chunk", lanes_for(rank),
                              tuple(sorted(choice.gather_modes)))
    elif variant not in (None, choice.variant):
        raise ValueError(f"build_plan: mode {mode} of shape {shape} at rank "
                         f"{rank} takes the {choice.variant} kernel, not "
                         f"{variant!r}")
    dev = indices.device
    nnz = indices.shape[0]
    if nnz:
        lo = indices.amin(0).tolist()
        hi = indices.amax(0).tolist()
        if min(lo) < 0 or any(h >= d for h, d in zip(hi, shape)):
            raise ValueError(f"build_plan: coordinates span {lo}..{hi}, "
                             f"outside shape {shape}")
    D = shape[mode]
    gm = choice.gather_modes
    rows = indices[:, mode].long()
    key = rows
    if choice.variant == "fiber":
        key = rows * shape[gm[0]] + indices[:, gm[0]].long()
    order = torch.sort(key, stable=True).indices
    coords = indices[order][:, list(gm)].to(torch.int32).contiguous()
    vals = values[order].contiguous()
    counts = torch.bincount(rows, minlength=D)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    rowptr = torch.cat([zero, torch.cumsum(counts, 0)])
    per_row = (counts + CHUNK - 1) // CHUNK
    chunk_ptr = torch.cat([zero, torch.cumsum(per_row, 0)])
    nchunks = int(chunk_ptr[-1])
    row_of = torch.repeat_interleave(torch.arange(D, device=dev), per_row,
                                     output_size=nchunks)
    piece = torch.arange(nchunks, device=dev) - chunk_ptr[row_of]
    chunk_start = torch.cat([rowptr[row_of] + piece * CHUNK,
                             torch.full((1,), nnz, dtype=torch.int64,
                                        device=dev)])
    return SparsePlan(out_mode=mode, gather_modes=gm, shape=shape,
                      variant=choice.variant, lanes=choice.lanes,
                      coords=coords, vals=vals, rowptr=rowptr,
                      chunk_ptr=chunk_ptr, chunk_start=chunk_start)


def mttkrp_sparse_reference(indices: torch.Tensor, values: torch.Tensor,
                            factors, mode: int, out_dim: int) -> torch.Tensor:
    """Plain PyTorch version, the counterpart of the JAX package's
    ops/tensor.mttkrp_sparse: the gathered rows multiplied in mode order,
    then summed into the target rows with index_add_."""
    contrib = values[:, None]
    for j, f in enumerate(factors):
        if j != mode:
            contrib = contrib * f[indices[:, j].long()]
    out = torch.zeros((out_dim, contrib.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, indices[:, mode].long(), contrib)


def _plan_indices(plan: SparsePlan) -> torch.Tensor:
    """The (nnz, ndim) coordinates of a plan's nonzeros, in plan order."""
    counts = plan.rowptr[1:] - plan.rowptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(plan.out_dim, device=counts.device), counts)
    idx = torch.empty((plan.vals.shape[0], len(plan.shape)), dtype=torch.int64,
                      device=counts.device)
    idx[:, plan.out_mode] = rows
    idx[:, list(plan.gather_modes)] = plan.coords.long()
    return idx


def _lib():
    global _LIB
    if _LIB is None:
        from matlab_code_tpu_torch.ops._build import load_library
        lib = load_library("mttkrp_sparse", ["mttkrp_sparse.cu"])
        fn = lib.mttkrp_sparse_run
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.mttkrp_sparse_fiber_run
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fiber_lanes(lanes: int, itemsize: int) -> int:
    """Lanes a nonzero (Q) in the fiber kernel at a tile of `lanes` (P)
    columns: a lane holds 16 bytes of a row.  A warp is 32 / Q groups;
    each step group g walks nonzeros gQ .. gQ + Q - 1 of the warp's 32."""
    return lanes * itemsize // 16


def fiber_blocks(nchunks: int, sm_count: int) -> int:
    """Blocks of the fiber kernel: one a streaming multiprocessor, fewer
    where there are fewer chunks than warps (each block fills its tile)."""
    return max(1, min(sm_count, -(-nchunks // FIBER_WARPS)))


def mttkrp_sparse_cuda(plan: SparsePlan, factors) -> torch.Tensor:
    """MTTKRP into plan.out_mode.  factors: one (shape[m], R) matrix per
    mode (factors[plan.out_mode] is not read).  Returns (plan.out_dim, R)
    in the plan's value type.

    A plan on a CUDA card launches the kernel it names (and counts the call
    in mttkrp_sparse_cuda.launches) or raises; a plan on the CPU takes
    mttkrp_sparse_reference."""
    vals = plan.vals
    if len(factors) != len(plan.shape):
        raise ValueError(f"mttkrp_sparse_cuda: {len(factors)} factors for a "
                         f"{len(plan.shape)}-way tensor")
    if vals.device.type == "cpu":
        return mttkrp_sparse_reference(_plan_indices(plan), vals, factors,
                                       plan.out_mode, plan.out_dim)
    if vals.device.type != "cuda":
        raise ValueError(f"mttkrp_sparse_cuda: unsupported device {vals.device}")
    ng = len(plan.gather_modes)
    if not 1 <= ng <= NG_MAX:
        raise NotImplementedError(
            f"mttkrp_sparse_cuda takes tensors of order 2 to {NG_MAX + 1}, "
            f"got {len(plan.shape)}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"mttkrp_sparse_cuda takes float32 or float64 "
                         f"values, got {vals.dtype}")
    for name in ("coords", "vals", "chunk_ptr", "chunk_start"):
        t = getattr(plan, name)
        if t.device != vals.device or not t.is_contiguous():
            raise ValueError(f"mttkrp_sparse_cuda: plan.{name} must be "
                             f"contiguous on {vals.device}")
    if plan.coords.dtype != torch.int32 or plan.chunk_ptr.dtype != torch.int64 \
            or plan.chunk_start.dtype != torch.int64:
        raise ValueError("mttkrp_sparse_cuda: a plan from build_plan is "
                         "needed (int32 coords, int64 chunk tables)")
    if plan.lanes not in ((8, 16) if plan.variant == "fiber" else (8, 16, 32)):
        raise ValueError(f"mttkrp_sparse_cuda: plan.lanes {plan.lanes} does "
                         f"not suit the {plan.variant} kernel")
    ref = factors[plan.gather_modes[0]]
    R = ref.shape[1] if ref.dim() == 2 else -1
    if R < 1:
        raise ValueError(f"mttkrp_sparse_cuda: rank must be >= 1, got "
                         f"factor shape {tuple(ref.shape)}")
    for g in plan.gather_modes:
        f = factors[g]
        if f.device != vals.device or f.dtype != vals.dtype:
            raise ValueError(f"mttkrp_sparse_cuda: factor {g} is {f.dtype} on "
                             f"{f.device}, the values are {vals.dtype} on "
                             f"{vals.device}")
        if f.dim() != 2 or f.shape != (plan.shape[g], R) or not f.is_contiguous():
            raise ValueError(f"mttkrp_sparse_cuda: factor {g} must be a "
                             f"contiguous ({plan.shape[g]}, {R}) matrix, got "
                             f"{tuple(f.shape)}")
    D = plan.out_dim
    out = torch.empty((D, R), dtype=vals.dtype, device=vals.device)
    partial = torch.empty((plan.nchunks, R), dtype=vals.dtype,
                          device=vals.device)
    is_double = int(vals.dtype == torch.float64)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    if plan.variant == "fiber":
        fib, res = plan.gather_modes if ng == 2 else (None, None)
        if res is None or plan.shape[res] * plan.lanes * vals.element_size() \
                > SMEM_BYTES:
            raise ValueError(f"mttkrp_sparse_cuda: the fiber kernel takes a "
                             f"3-way tensor whose resident tile fits "
                             f"{SMEM_BYTES} bytes (shape {plan.shape}, mode "
                             f"{plan.out_mode}, P {plan.lanes})")
        err = _lib().mttkrp_sparse_fiber_run(
            is_double, plan.lanes, plan.coords.data_ptr(), vals.data_ptr(),
            plan.chunk_start.data_ptr(), plan.chunk_ptr.data_ptr(),
            factors[fib].data_ptr(), factors[res].data_ptr(),
            partial.data_ptr(), out.data_ptr(), plan.nchunks, D, R,
            plan.shape[res], fiber_blocks(plan.nchunks, _sm_count(vals.device)),
            stream)
    elif plan.variant == "chunk":
        ptrs = [factors[g].data_ptr() for g in plan.gather_modes]
        ptrs += [None] * (NG_MAX - ng)
        err = _lib().mttkrp_sparse_run(
            is_double, ng, plan.lanes, plan.coords.data_ptr(), vals.data_ptr(),
            plan.chunk_start.data_ptr(), plan.chunk_ptr.data_ptr(), *ptrs,
            partial.data_ptr(), out.data_ptr(), plan.nchunks, D, R, stream)
    else:
        raise ValueError(f"mttkrp_sparse_cuda: unknown plan variant "
                         f"{plan.variant!r}")
    if err != 0:
        raise RuntimeError(f"mttkrp_sparse launch failed: cudaError {err} "
                           f"({plan.variant} kernel, mode {plan.out_mode}, "
                           f"shape {plan.shape}, R={R}, P={plan.lanes}, "
                           f"{plan.nchunks} chunks)")
    mttkrp_sparse_cuda.launches += 1
    return out


mttkrp_sparse_cuda.launches = 0
