"""Problem specification: the static structure of a coupled factorization.

Counterpart of matlab_code_tpu/problem.py.  The spec classes are plain
Python copies with the same fields and methods (the JAX package's module
imports jax, which the port never loads); ProblemData holds torch tensors.

All mode indices are 0-based; coupling ids are 1-based with 0 = uncoupled.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from matlab_code_tpu_torch.ops.prox import ConstraintSpec  # re-export

CP = "CP"
PAR2 = "PAR2"


@dataclass(frozen=True)
class DatasetSpec:
    """One dataset: model type, its global modes, loss, weight, rank."""
    model: str                      # 'CP' | 'PAR2'
    modes: tuple[int, ...]          # global mode ids (0-based)
    rank: int
    loss: str = "Frobenius"
    loss_param: float | None = None
    weight: float = 1.0


@dataclass(frozen=True)
class CouplingSpec:
    """Linear coupling structure: lin_coupled_modes[m] = coupling id of mode
    m (0 = uncoupled); coupling_type[c-1] = type of coupling id c, in 0..5."""
    lin_coupled_modes: tuple[int, ...] = ()
    coupling_type: tuple[int, ...] = ()

    @property
    def n_couplings(self) -> int:
        return max(self.lin_coupled_modes, default=0)


@dataclass(frozen=True)
class ProblemSpec:
    """Static problem structure.  mode_sizes[m] is an int, or a tuple of ints
    for the (possibly ragged) Bk mode of a PARAFAC2 dataset."""
    mode_sizes: tuple
    datasets: tuple[DatasetSpec, ...]
    coupling: CouplingSpec = CouplingSpec()
    constraints: tuple = ()          # per mode: ConstraintSpec | None
    ridge: tuple | None = None       # per mode: float, or None for no ridge

    @property
    def nb_modes(self) -> int:
        return len(self.mode_sizes)

    def which_p(self, m: int) -> int:
        """Dataset index owning mode m (cmtf_fun_AOADMM.m:12-15)."""
        for p, ds in enumerate(self.datasets):
            if m in ds.modes:
                return p
        raise ValueError(f"mode {m} belongs to no dataset")

    def mode_role(self, m: int) -> str:
        """'cp' | 'par2_A' | 'par2_B' | 'par2_C'."""
        ds = self.datasets[self.which_p(m)]
        if ds.model == CP:
            return "cp"
        return ("par2_A", "par2_B", "par2_C")[ds.modes.index(m)]

    def mode_rank(self, m: int) -> int:
        return self.datasets[self.which_p(m)].rank

    def par2_K(self, p: int) -> int:
        return len(self.mode_sizes[self.datasets[p].modes[1]])

    def par2_Jmax(self, p: int) -> int:
        return max(self.mode_sizes[self.datasets[p].modes[1]])

    def par2_slice_sizes(self, p: int) -> tuple[int, ...]:
        return tuple(self.mode_sizes[self.datasets[p].modes[1]])

    def is_constrained(self, m: int) -> bool:
        return self.constraints and self.constraints[m] is not None

    def coupling_id(self, m: int) -> int:
        if not self.coupling.lin_coupled_modes:
            return 0
        return self.coupling.lin_coupled_modes[m]

    def coupled_modes_of(self, cid: int) -> tuple[int, ...]:
        return tuple(m for m in range(self.nb_modes)
                     if self.coupling_id(m) == cid)

    def coupling_ids(self) -> tuple[int, ...]:
        """unique(lin_coupled_modes) including 0 if any uncoupled mode exists
        (cmtf_fun_AOADMM.m:10)."""
        if not self.coupling.lin_coupled_modes:
            return (0,)
        return tuple(sorted(set(self.coupling.lin_coupled_modes)))

    def has_non_frobenius(self) -> bool:
        return any(ds.loss != "Frobenius" for ds in self.datasets)


@dataclass
class SparseTensor:
    """COO sparse tensor for CP datasets (the reference's Tensor Toolbox
    `sptensor`), counterpart of matlab_code_tpu.problem.SparseTensor.
    indices (nnz, ndim) int32, values (nnz,).  Restricted to Frobenius loss
    and incompatible with missing-data masks (cmtf_AOADMM.m:77-79).

    plans: None, or one ops.sparse_cuda.SparsePlan per mode (the layout the
    CUDA MTTKRP kernel reads); attach with `with_plans()` (fit() does so for
    a tensor on a CUDA card).  A plan depends on the sparsity pattern and
    carries the values in its own order.
    """
    indices: torch.Tensor
    values: torch.Tensor
    plans: tuple | None = None

    @property
    def ndim(self) -> int:
        return self.indices.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def with_plans(self, shape, rank: int) -> "SparseTensor":
        """The same tensor with a kernel plan for every mode, built with torch
        ops on the tensor's device.  shape: the dense mode sizes; rank: the
        CP rank the plans are laid out for (any rank runs through them)."""
        from matlab_code_tpu_torch.ops.sparse_cuda import build_plan
        plans = tuple(build_plan(self.indices, self.values, shape, m, rank)
                      for m in range(self.ndim))
        return SparseTensor(self.indices, self.values, plans)

    @staticmethod
    def from_dense(X, threshold=0.0) -> "SparseTensor":
        """The entries of X with |x| > threshold, in C order of their
        coordinates; X is a torch tensor or anything np.asarray takes."""
        X = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))
        idx = torch.nonzero(X.abs() > threshold)
        return SparseTensor(idx.to(torch.int32), X[tuple(idx.T)])

    def to_dense(self, shape) -> torch.Tensor:
        """Dense tensor of `shape`; duplicate coordinates are summed."""
        out = torch.zeros(tuple(shape), dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put_(tuple(self.indices.long().T), self.values,
                              accumulate=True)


@dataclass
class Parafac2Tensor:
    """Padded ragged PARAFAC2 data (counterpart of
    matlab_code_tpu.problem.Parafac2Tensor): slices (K, I, Jmax), zero past
    each slice's J_k columns; mask (K, Jmax) bool, True = real column of
    slice k."""
    slices: torch.Tensor
    mask: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.slices.dtype

    @property
    def device(self) -> torch.device:
        return self.slices.device

    @staticmethod
    def from_list(slice_list, dtype=None, device="cuda") -> "Parafac2Tensor":
        """Stack K slices X_k (I, J_k) (torch tensors or anything np.asarray
        takes) into the padded form, on `device` (the card unless asked
        for the CPU)."""
        mats = [s if isinstance(s, torch.Tensor) else torch.as_tensor(np.asarray(s))
                for s in slice_list]
        dt = dtype or mats[0].dtype
        K, I = len(mats), mats[0].shape[0]
        Jmax = max(s.shape[1] for s in mats)
        out = torch.zeros((K, I, Jmax), dtype=dt, device=device)
        mask = torch.zeros((K, Jmax), dtype=torch.bool, device=device)
        for k, s in enumerate(mats):
            out[k, :, :s.shape[1]] = s.to(dtype=dt, device=device)
            mask[k, :s.shape[1]] = True
        return Parafac2Tensor(out, mask)

    def to_list(self, sizes) -> list:
        return [self.slices[k, :, :j] for k, j in enumerate(sizes)]


@dataclass
class ProblemData:
    """Tensor side of the problem.

    objects[p]: CP -> dense torch tensor or SparseTensor; PAR2 ->
                Parafac2Tensor.
    miss[p]:    None or a boolean mask, True = observed entry.
    coupl_trafo[m], coupl_trafo2[m]: None or the H / H2 matrices.
    layout:     None for the full data; on a mesh (parallel/), the
                sharding tree this rank's blocks were cut by
                (parallel/sharding.device_put): objects and miss then hold
                this rank's blocks where their shards say so.
    """
    objects: tuple
    miss: tuple = ()
    coupl_trafo: tuple = ()
    coupl_trafo2: tuple = ()
    layout: "ProblemData | None" = None

    def __post_init__(self):
        if not self.miss:
            self.miss = tuple(None for _ in self.objects)


def has_missing(data: ProblemData) -> bool:
    return any(m is not None for m in data.miss)


def check_data_input(spec: ProblemSpec, data: ProblemData | None = None) -> None:
    """Validate coupling/model shape contracts (check_data_input.m:1-159),
    the same rules as matlab_code_tpu.problem.check_data_input.  Raises
    ValueError on violation."""
    nmodes = spec.nb_modes
    seen = [m for ds in spec.datasets for m in ds.modes]
    if sorted(seen) != list(range(nmodes)):
        raise ValueError("Mismatch between mode_sizes and dataset modes")
    cpl = spec.coupling
    if cpl.lin_coupled_modes and len(cpl.lin_coupled_modes) != nmodes:
        raise ValueError("lin_coupled_modes must have one entry per mode")
    if cpl.n_couplings != len(cpl.coupling_type):
        raise ValueError("Mismatch between number of couplings and coupling types")

    if data is not None:
        for p, ds in enumerate(spec.datasets):
            if data.miss[p] is not None and ds.loss != "Frobenius":
                raise ValueError(
                    "Missing data (miss) is only supported for Frobenius "
                    "loss functions")
            if isinstance(data.objects[p], SparseTensor):
                if ds.loss != "Frobenius":
                    raise ValueError(
                        "Sparse tensors are only supported with Frobenius "
                        "loss")
                if data.miss[p] is not None:
                    raise ValueError(
                        "Missing data (miss) not supported for sparse "
                        "tensors")
    for p, ds in enumerate(spec.datasets):
        if ds.model == PAR2:
            szB = spec.mode_sizes[ds.modes[1]]
            if not isinstance(szB, (tuple, list)):
                raise ValueError(
                    f"PAR2 dataset {p}: Bk mode size must be a tuple of slice sizes")
            if spec.mode_sizes[ds.modes[2]] != len(szB):
                raise ValueError(
                    "size mismatch in PARAFAC2 model between mode C and Bk "
                    f"(dataset {p})")
            if ds.loss != "Frobenius":
                raise ValueError(
                    "Parafac2 decomposition only implemented for Frobenius loss")
            if spec.coupling_id(ds.modes[1]) != 0:
                raise ValueError(
                    "Coupling in 2. mode (the varying mode) of Parafac2 "
                    "not supported")
            for k, J in enumerate(szB):
                if J < ds.rank:
                    raise ValueError(
                        f"Rank {ds.rank} larger than slice {k} size {J} of "
                        f"PAR2 dataset {p}")
        for m in ds.modes:
            c = spec.constraints[m] if spec.constraints else None
            if c is not None and c.kind == "tPARAFAC2":
                if ds.model != PAR2 or ds.modes.index(m) != 1:
                    raise ValueError(
                        "The tPARAFAC2 constraint can only be imposed on the "
                        "second mode of a PARAFAC2 model")
                if len(set(spec.mode_sizes[m])) > 1:
                    raise ValueError(
                        "tPARAFAC2 requires equal slice sizes (the temporal "
                        "difference ||B_k - B_{k-1}|| is undefined for "
                        "ragged slices)")
        if ds.model == PAR2:
            mB = ds.modes[1]
            c = spec.constraints[mB] if spec.constraints else None
            ragged = len(set(spec.mode_sizes[mB])) > 1
            if c is not None and ragged and c.kind in {
                    "GL smoothness", "quadratic regularization"}:
                raise ValueError(
                    f"Constraint {c.kind!r} on a ragged PARAFAC2 Bk mode is "
                    "not supported: its operator matrix is built for a single "
                    "fixed slice size")

    for cid in range(1, cpl.n_couplings + 1):
        ctype = cpl.coupling_type[cid - 1]
        cmodes = spec.coupled_modes_of(cid)
        ranks = {spec.mode_rank(m) for m in cmodes}
        if ctype in (0, 1, 3) and len(ranks) > 1:
            raise ValueError(
                f"Coupled modes {cmodes} need the same number of components")
        if ctype in (0, 2, 4):
            rows = {spec.mode_sizes[m] for m in cmodes}
            if len(rows) > 1:
                raise ValueError(
                    f"Coupled factor matrices of modes {cmodes} need the same "
                    "number of rows")
        if data is not None and ctype != 0:
            for m in cmodes:
                H = data.coupl_trafo[m] if data.coupl_trafo else None
                if H is None:
                    raise ValueError(f"Coupling matrix for mode {m} is missing")
                H = np.asarray(H.cpu() if hasattr(H, "cpu") else H)
                R = spec.mode_rank(m)
                if ctype in (1, 5):
                    if np.linalg.matrix_rank(H) < H.shape[0]:
                        raise ValueError(
                            f"Coupling matrix for mode {m} is not right-invertible")
                    if H.shape[1] != spec.mode_sizes[m]:
                        raise ValueError(
                            f"Mismatch between size and columns of H for mode {m}")
                if ctype == 2:
                    if H.shape[0] != R:
                        raise ValueError(
                            f"Mismatch between rank and rows of H for mode {m}")
                    if H.shape[1] > R:
                        raise ValueError(
                            f"Coupling matrix for mode {m} cannot have more "
                            "columns than rows")
                if ctype == 3 and H.shape[0] != spec.mode_sizes[m]:
                    raise ValueError(
                        f"Mismatch between size and rows of H for mode {m}")
                if ctype == 4 and H.shape[1] != R:
                    raise ValueError(
                        f"Mismatch between rank and columns of H for mode {m}")
                if ctype == 5:
                    H2 = data.coupl_trafo2[m] if data.coupl_trafo2 else None
                    if H2 is None:
                        raise ValueError(
                            f"Coupling matrix H2 for mode {m} is missing")
