"""Data layouts over a mesh of ranks (counterpart of
matlab_code_tpu/parallel/sharding.py), on torch.distributed.

A mesh is a 1-D group of ranks on the axis DATA_AXIS, one rank a device.
Every rank holds the same full problem (the JAX package's globalize makes
the same assumption); device_put cuts this rank's blocks of it once:

  * a dense CP dataset (a matrix too) is cut along its longest mode whose
    size the mesh size divides (choose_cp_shard_mode), into equal
    contiguous blocks, block r on rank r; its missing-data mask alike;
  * a sparse COO dataset is cut along its nonzero axis where the mesh size
    divides nnz (parallel/shard_mttkrp.pad_sparse_nnz pads it so); the
    kernel plans are built again on each block (fit, attach_sparse_plans);
  * a PARAFAC2 dataset is cut along its slice axis K where the mesh size
    divides K (the JAX rule): its slices, column mask and missing-data
    mask, and in the solver state its Bk factor (with the Bk constraint
    and dual factors), P and mu_DeltaB (state_shardings).  Its C factor
    (K x R) and DeltaB stay replicated, where the JAX package cuts C too:
    every C-side path (the row-wise update, the coupled Delta solves, the
    column-wise proxes along K, the coupling gaps) then runs as it does
    without a mesh, and the par2C precompute gathers the rows each rank
    computed from its slices.  Each sum over K is a sum over the rank's
    slices and one collective (models/updates.py, models/admm.py,
    models/objective.py).  A dataset whose Bk carries the tPARAFAC2
    constraint stays replicated (data_shardings' par2='auto'): its prox
    is a solve along K, which under a cut runs on the stack all-gathered
    every inner step, and on two and four cards that cut was the slower
    layout; par2='cut' cuts it as the JAX package does;
  * everything else is replicated: a dense CP dataset with no divisible
    mode, a sparse one whose nnz the mesh size does not divide, a
    PARAFAC2 one whose K it does not divide, and every other state leaf.

The reads of a cut dataset (the MTTKRPs, the PARAFAC2 precomputes, the
objective's data terms, the data constants, EM imputation, the loss pass of
L-BFGS-B) reduce across the ranks (parallel/shard_mttkrp.py,
parallel/collectives.py); everything else is computed replicated on
identical inputs, so every rank holds the same state bits and takes the
same decision on each device read.  fit gathers the cut state leaves at
its exit, so every rank returns the full state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from matlab_code_tpu_torch.problem import (
    CP, PAR2, Parafac2Tensor, ProblemData, ProblemSpec, SparseTensor)
from matlab_code_tpu_torch.state import FIELDS, SolverState

DATA_AXIS = "d"
COLLECTIVES = ("psum", "all_gather", "ring", "gather_object")


@dataclass(eq=False)
class Mesh:
    """A 1-D mesh of `size` ranks on DATA_AXIS (the counterpart of a jax
    Mesh of shape (size,)): this process is the mesh's rank `rank`, its
    tensors lie on `device`, and `group` is the torch.distributed process
    group the collectives run over (None: a mesh only to lay data out by,
    which runs no collective), `ranks` the group's global ranks, `backend`
    its backend ('nccl' or 'gloo'), which alone picks the collectives'
    transport.  `counts` and `stage_seconds` count each collective's calls
    and the host-clock seconds of its copies between the card and the host
    (parallel/collectives.py); reset_stats() zeroes both."""
    size: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = None
    ranks: tuple = ()
    backend: str | None = None
    counts: dict = field(default_factory=dict)
    stage_seconds: dict = field(default_factory=dict)

    def __post_init__(self):
        self.device = torch.device(self.device)
        if not self.ranks:
            self.ranks = tuple(range(self.size))
        self.reset_stats()

    def reset_stats(self) -> None:
        self.counts.update({c: 0 for c in COLLECTIVES})
        self.stage_seconds.update({c: 0.0 for c in COLLECTIVES})


def make_mesh(n_devices: int | None = None, group=None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over every rank of `group` (the default process group when
    None; torch.distributed must be initialized, parallel/distributed.
    initialize).  n_devices, where given, must be the group's size: a mesh
    of fewer ranks is a group of its own (torch.distributed.new_group,
    which every rank creates together).  device: this rank's device, by
    default its card (parallel/distributed.rank_device) or the CPU."""
    import torch.distributed as dist
    from matlab_code_tpu_torch.parallel.distributed import rank_device
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: the group has {size} ranks, not "
                         f"{n_devices}; pass a group of {n_devices} ranks "
                         "(torch.distributed.new_group)")
    rank = dist.get_rank(group)
    ranks = tuple(dist.get_process_group_ranks(group or dist.group.WORLD))
    return Mesh(size=size, rank=rank,
                device=device if device is not None else rank_device(),
                group=group, ranks=ranks, backend=dist.get_backend(group))


@dataclass(frozen=True, eq=False)
class Shard:
    """How one tensor lies over `mesh`: cut along `axis` into mesh.size
    equal contiguous blocks, block r on rank r, or replicated (axis None):
    the counterpart of a NamedSharding on the 1-D mesh.  A replicated
    Shard's rank holds the whole: its rows, local_factors, psum and gather
    return their input, so that code over a dataset, cut or not, takes one
    path (dataset_shard; UNCUT for data that no mesh lays out)."""
    mesh: Mesh | None
    axis: int | None = None

    @property
    def cut(self) -> bool:
        return self.axis is not None

    def block(self, x) -> torch.Tensor:
        """This rank's block of the full value x (a torch tensor or anything
        np.asarray takes), row-major on the mesh's device.  A block along
        axis 0 of a row-major tensor already on the device is a view; any
        other block is a copy (the dense kernel reads row-major X only)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))     # a copy of its own
        if self.cut:
            b = x.shape[self.axis] // self.mesh.size
            x = x.narrow(self.axis, self.mesh.rank * b, b)
        return x.to(self.mesh.device).contiguous()

    def rows(self, U):
        """This rank's rows of U, the factor matrix of the cut mode or a
        full stack along the cut K axis (a contiguous view of a row-major
        U), or its part of a sequence (a PARAFAC2 dataset's slice
        sizes)."""
        if not self.cut:
            return U
        b = len(U) // self.mesh.size
        return U[self.mesh.rank * b:(self.mesh.rank + 1) * b]

    def local_factors(self, factors) -> list:
        """A dense dataset's factors for this rank's block: the cut mode's
        factor sliced to the block's rows, the others whole."""
        out = list(factors)
        if self.cut:
            out[self.axis] = self.rows(out[self.axis])
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of each one's partial value t (of a cut
        tensor's block); t itself where the tensor is replicated."""
        if not self.cut:
            return t
        from matlab_code_tpu_torch.parallel.collectives import psum
        return psum(t, self.mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block t along the cut axis,
        on every rank (a tiled all_gather); t itself where replicated."""
        if not self.cut:
            return t
        from matlab_code_tpu_torch.parallel.collectives import all_gather
        return all_gather(t, self.mesh, axis=self.axis)


UNCUT = Shard(None)     # the Shard of every dataset of full data


def choose_cp_shard_mode(spec: ProblemSpec, p: int, n_devices: int
                         ) -> int | None:
    """Local index of the longest mode divisible by the mesh size, or None."""
    ds = spec.datasets[p]
    sizes = [spec.mode_sizes[m] for m in ds.modes]
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    for i in order:
        if sizes[i] % n_devices == 0:
            return i
    return None


PAR2_LAYOUTS = ("auto", "cut", "replicated")


def data_shardings(spec: ProblemSpec, data: ProblemData, mesh: Mesh,
                   par2: str = "auto"):
    """(shardings, sharded_modes): a ProblemData whose leaves are Shards
    (a SparseTensor of two Shards for COO data, a Parafac2Tensor of two for
    PARAFAC2 data), and {global mode: True} of every cut dense mode and of
    the Bk and C modes of every PARAFAC2 dataset cut along K: the JAX
    function's decisions, but for a tPARAFAC2 dataset.  A missing-data mask
    is cut as its dataset.  par2: 'auto' cuts a PARAFAC2 dataset along K
    where the mesh size divides K, but replicates one whose Bk carries the
    tPARAFAC2 constraint; 'cut' cuts that one too (the JAX package's rule:
    its prox, a solve along K, then runs on the all-gathered stack every
    inner step); 'replicated' replicates every PARAFAC2 dataset.  fit lays
    data out by 'auto'; device_put of the others' shardings lays data out
    by hand, as phase 24 of chip_smoke.py and utils/time_par2_mesh.py do to
    time the layouts."""
    if par2 not in PAR2_LAYOUTS:
        raise ValueError(f"par2={par2!r}: not one of {PAR2_LAYOUTS}")
    n = mesh.size
    rep = Shard(mesh)
    objects, sharded_modes = [], {}
    for p, ds in enumerate(spec.datasets):
        X = data.objects[p]
        if ds.model == CP and isinstance(X, SparseTensor):
            cut = Shard(mesh, 0) if X.indices.shape[0] % n == 0 else rep
            objects.append(SparseTensor(indices=cut, values=cut))
        elif ds.model == CP:
            local = choose_cp_shard_mode(spec, p, n)
            objects.append(Shard(mesh, local))
            if local is not None:
                sharded_modes[ds.modes[local]] = True
        else:
            mB = ds.modes[1]
            tpar2 = (spec.is_constrained(mB)
                     and spec.constraints[mB].kind == "tPARAFAC2")
            cut = (Shard(mesh, 0) if X.slices.shape[0] % n == 0 and (
                par2 == "cut" or par2 == "auto" and not tpar2) else rep)
            objects.append(Parafac2Tensor(slices=cut, mask=cut))
            if cut.axis is not None:
                sharded_modes[ds.modes[1]] = True
                sharded_modes[ds.modes[2]] = True
    miss = tuple(None if m is None else _like_object(objects[p], rep)
                 for p, m in enumerate(data.miss))
    trafo = tuple(None if H is None else rep for H in data.coupl_trafo)
    trafo2 = tuple(None if H is None else rep for H in data.coupl_trafo2)
    return dataclasses.replace(data, objects=tuple(objects), miss=miss,
                               coupl_trafo=trafo, coupl_trafo2=trafo2,
                               layout=None), sharded_modes


def _like_object(obj_sh, rep: Shard) -> Shard:
    """A missing-data mask's Shard: its dataset's (a PARAFAC2 dataset's
    slices'), replicated for a COO dataset (the JAX package's o_sh_like)."""
    if isinstance(obj_sh, Shard):
        return obj_sh
    return obj_sh.slices if isinstance(obj_sh, Parafac2Tensor) else rep


def state_shardings(spec: ProblemSpec, state: SolverState, mesh: Mesh,
                    sharded_modes: dict) -> SolverState:
    """A SolverState of Shards: the K-carrying leaves of every PARAFAC2
    dataset whose Bk mode is in sharded_modes cut along axis 0 (its Bk
    factor, Bk constraint and dual factors, P and mu_DeltaB), every other
    leaf replicated.  The JAX function also cuts the C factor; the port
    keeps C replicated (module docstring), and no factor of a cut CP mode
    is cut."""
    rep, cut = Shard(mesh), Shard(mesh, 0)
    cut_modes, cut_p = set(), set()
    for p, ds in enumerate(spec.datasets):
        if ds.model == PAR2 and ds.modes[1] in sharded_modes:
            cut_modes.add(ds.modes[1])
            cut_p.add(p)
    out = {}
    for k in FIELDS:
        keys = cut_p if k in ("P", "mu_DeltaB") else (
            cut_modes if k in ("fac", "constraint_fac", "constraint_dual_fac")
            else ())
        out[k] = tuple(None if x is None else (cut if i in keys else rep)
                       for i, x in enumerate(getattr(state, k)))
    return SolverState(**out)


def _put(x, sh):
    if x is None:
        return None
    if isinstance(sh, SparseTensor):
        cut = sh.values.axis is not None
        return SparseTensor(sh.indices.block(x.indices),
                            sh.values.block(x.values),
                            None if cut or x.plans is None else x.plans)
    if isinstance(sh, Parafac2Tensor):
        return Parafac2Tensor(sh.slices.block(x.slices), sh.mask.block(x.mask))
    return sh.block(x)


def device_put(tree, shardings):
    """The counterpart of jax.device_put(tree, shardings) on a mesh: this
    rank's blocks of a full ProblemData (data_shardings), cut once, with
    the shardings kept as its `layout` so that fit knows them, or a
    SolverState's tensors on the mesh's device (state_shardings).  Leaves
    may be torch tensors or numpy arrays."""
    if isinstance(tree, SolverState):
        return SolverState(**{k: tuple(_put(x, s) for x, s in
                                       zip(getattr(tree, k),
                                           getattr(shardings, k)))
                              for k in FIELDS})
    pick = lambda name: tuple(_put(x, s) for x, s in
                              zip(getattr(tree, name), getattr(shardings, name)))
    return dataclasses.replace(
        tree, objects=pick("objects"), miss=pick("miss"),
        coupl_trafo=pick("coupl_trafo"), coupl_trafo2=pick("coupl_trafo2"),
        layout=shardings)


def dataset_shard(data: ProblemData, p: int) -> Shard:
    """The Shard dataset p of laid-out data is cut by (a COO dataset's:
    along its nonzeros; a PARAFAC2 dataset's: along K), or a replicated
    one (UNCUT where the data are full)."""
    if data.layout is None:
        return UNCUT
    sh = data.layout.objects[p]
    if isinstance(sh, SparseTensor):
        return sh.values
    return sh.slices if isinstance(sh, Parafac2Tensor) else sh


def par2_cut_modes(spec: ProblemSpec, data: ProblemData) -> dict:
    """{mode: True} of the Bk and C modes of every PARAFAC2 dataset that
    laid-out data cut along K (state_shardings' sharded_modes)."""
    return {m: True for p, ds in enumerate(spec.datasets)
            if ds.model == PAR2 and dataset_shard(data, p).cut
            for m in ds.modes[1:]}


def mesh_of(data: ProblemData) -> Mesh | None:
    """The mesh laid-out data lie on, None for full data."""
    if data.layout is None:
        return None
    sh = data.layout.objects[0]
    return (sh.values if isinstance(sh, SparseTensor) else
            sh.slices if isinstance(sh, Parafac2Tensor) else sh).mesh


def lay_out(spec: ProblemSpec, data: ProblemData, state: SolverState,
            mesh: Mesh):
    """(data, state) on `mesh`: full data cut by data_shardings (data laid
    out already are kept), the full state cut by state_shardings on the
    mesh's device (the counterpart of solver.py:905-913 of the JAX
    package).  A state whose K-cut leaves are this rank's blocks already
    (distributed.globalize_tree) is only moved to the device."""
    if data.layout is None:
        data_sh, sharded_modes = data_shardings(spec, data, mesh)
        data = device_put(data, data_sh)
    else:
        sharded_modes = par2_cut_modes(spec, data)
    cut = any(state.fac[ds.modes[1]].shape[0] != spec.par2_K(p)
              for p, ds in enumerate(spec.datasets)
              if ds.model == PAR2 and ds.modes[1] in sharded_modes)
    return data, device_put(state, state_shardings(
        spec, state, mesh, {} if cut else sharded_modes))
