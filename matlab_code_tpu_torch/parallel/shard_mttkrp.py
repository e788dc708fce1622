"""Sharded MTTKRPs (counterpart of matlab_code_tpu/parallel/shard_mttkrp.py):
each rank's MTTKRP of its block, then a collective.

The JAX package writes them with shard_map; here each rank runs them on its
own block, through ops/tensor.py, so on a card the hand-written kernels do
the local products: mttkrp3 (csrc/mttkrp3.cu) on a dense 3-way block, given
the cut mode's factor rows as a contiguous row slice, and the sparse kernel
(csrc/mttkrp_sparse.cu) on a COO block through the plans fit builds for
that block.  A 2-way block takes the plain product X U or X^T U that
cp_mode_precompute forms for a matrix (the JAX package leaves matrices to
XLA's partitioner).  The factors come in whole (the state is replicated)."""
from __future__ import annotations

import torch

from matlab_code_tpu_torch.ops.tensor import mttkrp, mttkrp_sparse
from matlab_code_tpu_torch.parallel.collectives import (
    all_gather, psum, ring_send)
from matlab_code_tpu_torch.parallel.sharding import (
    Mesh, Shard, data_shardings)
from matlab_code_tpu_torch.problem import CP, SparseTensor


def local_mttkrp(X: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """The MTTKRP of one block: ops/tensor.mttkrp for 3 or more ways, the
    product cp_mode_precompute forms for a matrix."""
    if X.dim() == 2:
        other = factors[1 - mode]
        return X @ other if mode == 0 else X.T @ other
    return mttkrp(X, list(factors), mode)


def make_sharded_mttkrp(mesh: Mesh, shard_dim: int, target_mode: int):
    """mttkrp(X_block, factors) of a dense tensor cut along shard_dim,
    giving the whole mode-target_mode MTTKRP on every rank: the rows of the
    block's MTTKRP gathered (all_gather) where target_mode is the cut mode,
    its partial sums added (psum) otherwise.  The JAX function's axis and
    ndim are not taken: a mesh has the one axis DATA_AXIS, and X says its
    order."""
    shard = Shard(mesh, shard_dim)

    def f(x_block, factors):
        local = local_mttkrp(x_block, shard.local_factors(factors),
                             target_mode)
        if target_mode == shard_dim:
            return all_gather(local, mesh)
        return psum(local, mesh)

    return f


def make_sharded_mttkrp_pipelined(mesh: Mesh, shard_dim: int,
                                  target_mode: int):
    """The ring form of make_sharded_mttkrp for target_mode != shard_dim
    (the target's size divisible by n = mesh.size): the target's rows in
    n chunks; at step t rank d adds its MTTKRP of chunk
    (d - 1 - t) mod n to the accumulator that arrived for that chunk and
    sends it on to rank d + 1, the exchange in flight while the next chunk's
    MTTKRP runs (batch_isend_irecv); after n - 1 steps rank d holds chunk d
    summed, and a tiled all_gather gives every rank the whole.  The
    association order is the JAX function's (received + local).

    The kernel reads row-major blocks only: chunks along mode 0 are views of
    the block; chunks along another mode are cut once for each block the
    function meets (one copy of the block, held while that block is in
    use; .chunk_bytes says how many bytes), so a fit cuts them at its
    first sweep and again only where EM imputation gives new data."""
    n = mesh.size
    shard = Shard(mesh, shard_dim)
    held = {}

    def chunks(x):
        if held.get("x") is not x:
            ch = x.shape[target_mode] // n
            parts = [x.narrow(target_mode, c * ch, ch) for c in range(n)]
            if target_mode != 0:
                parts = [q.contiguous() for q in parts]
            held.update(x=x, parts=parts)
            f.chunk_bytes = (0 if target_mode == 0 else
                             sum(q.numel() * q.element_size() for q in parts))
        return held["parts"]

    def f(x_block, factors):
        facs = shard.local_factors(factors)
        ch = factors[target_mode].shape[0] // n
        parts = chunks(x_block)

        def step(t):
            c = (mesh.rank + n - 1 - t) % n
            fc = list(facs)
            fc[target_mode] = facs[target_mode].narrow(0, c * ch, ch)
            return local_mttkrp(parts[c], fc, target_mode)

        acc = step(0)
        for t in range(1, n):
            pending = ring_send(acc, mesh)
            p = step(t)
            acc = pending.wait() + p
        return all_gather(acc, mesh)

    f.chunk_bytes = 0
    return f


def make_sharded_mttkrp_sparse(mesh: Mesh, target_mode: int, out_dim: int):
    """mttkrp(X_block, factors) of a COO tensor cut along its nonzeros:
    each rank's (out_dim, R) MTTKRP of its nonzeros (the sparse kernel
    through the block's plan on a card), then psum.  Zero-valued padding
    (pad_sparse_nnz) adds exactly zero."""
    def fn(X, factors):
        local = mttkrp_sparse(
            X.indices, X.values, list(factors), target_mode, out_dim,
            plan=None if X.plans is None else X.plans[target_mode])
        return psum(local, mesh)

    return fn


def pad_sparse_nnz(X: SparseTensor, n: int) -> SparseTensor:
    """Pad a SparseTensor's nnz axis to a multiple of n with zero-valued
    entries at index 0 (exactly neutral for MTTKRP and the objective); its
    plans, if any, are kept: the padding adds zero to what they compute."""
    nnz = X.indices.shape[0]
    pad = (-nnz) % n
    if pad == 0:
        return X
    idx = torch.cat([X.indices, torch.zeros((pad, X.indices.shape[1]),
                                            dtype=X.indices.dtype,
                                            device=X.indices.device)])
    val = torch.cat([X.values, torch.zeros((pad,), dtype=X.values.dtype,
                                           device=X.values.device)])
    return SparseTensor(idx, val, X.plans)


def build_sharded_mttkrps(spec, data, mesh: Mesh, pipelined: bool = False
                          ) -> dict:
    """{(p, target local mode): fn(X, factors)} for every CP dataset the
    layout cuts (data.layout, or data_shardings' decision for full data),
    for make_outer_step(..., mttkrp_impls=): a COO dataset cut along its
    nonzeros takes make_sharded_mttkrp_sparse, a dense one (a matrix too)
    make_sharded_mttkrp.  pipelined=True (AlgOptions.
    mesh_pipelined_collectives) takes the ring form for every target of a
    dense tensor of 3 or more ways that is not the cut mode and whose size
    the mesh size divides (the JAX function's rule)."""
    n = mesh.size
    layout = data.layout or data_shardings(spec, data, mesh)[0]
    impls = {}
    for p, ds in enumerate(spec.datasets):
        if ds.model != CP:
            continue
        sh = layout.objects[p]
        if isinstance(sh, SparseTensor):
            if sh.values.axis is None:
                continue
            for target in range(len(ds.modes)):
                impls[(p, target)] = make_sharded_mttkrp_sparse(
                    mesh, target, spec.mode_sizes[ds.modes[target]])
            continue
        local = sh.axis
        if local is None:
            continue
        nd = len(ds.modes)
        for target in range(nd):
            if (pipelined and nd >= 3 and target != local
                    and spec.mode_sizes[ds.modes[target]] % n == 0):
                impls[(p, target)] = make_sharded_mttkrp_pipelined(
                    mesh, local, target)
            else:
                impls[(p, target)] = make_sharded_mttkrp(
                    mesh, local, target)
    return impls


def block_mttkrp(shard: Shard, X: torch.Tensor, factors, mode: int
                 ) -> torch.Tensor:
    """The whole mode-`mode` MTTKRP of a dense tensor cut like `shard` (an
    L-BFGS-B evaluation's gh tensor), by the bulk collective."""
    return make_sharded_mttkrp(shard.mesh, shard.axis, mode)(X, factors)
