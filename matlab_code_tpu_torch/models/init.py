"""Initialization of the solver state (init_coupled_AOADMM_CMTF.m),
counterpart of the CP part of matlab_code_tpu/models/init.py: random draws
or spectral ('nvecs') factors, constraint auxiliaries through every CP
prox, coupling Delta and duals for types 0-5.

Draws come from an explicit torch.Generator, in the JAX package's order
(factors per dataset and mode, then constraint auxiliaries and duals, then
couplings).  torch and jax.random give different numbers from the same
seed, so a run that must match the JAX package moves its init state across
with convert.state_from_numpy.  nvecs factors take no draw and match the
JAX package's.  PARAFAC2 init comes with slice 4.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.models.admm import _check_ctype
from matlab_code_tpu_torch.ops.linalg import top_eigvecs
from matlab_code_tpu_torch.ops.tensor import unfold
from matlab_code_tpu_torch.options import InitOptions
from matlab_code_tpu_torch.problem import (
    CP, ProblemData, ProblemSpec, SparseTensor)
from matlab_code_tpu_torch.state import SolverState


def _sampler(distr):
    if callable(distr):
        return distr
    if distr == "rand":
        return lambda g, shape, dt, dev: torch.rand(shape, generator=g, dtype=dt,
                                                    device=dev)
    if distr == "randn":
        return lambda g, shape, dt, dev: torch.randn(shape, generator=g, dtype=dt,
                                                     device=dev)
    if distr == "rand+0.1":
        return lambda g, shape, dt, dev: torch.rand(
            shape, generator=g, dtype=dt, device=dev) + 0.1
    raise ValueError(f"Unknown distr {distr!r}")


def _normalize_cols(A):
    return A / torch.linalg.vector_norm(A, dim=0, keepdim=True)


def _coo_unfolding_gram(X: SparseTensor, shape, mode: int) -> np.ndarray:
    """Gram U_mode @ U_mode.T of the mode unfolding of a COO tensor without
    densifying (the reference's sptenmat path, cmtf_nvecs.m:41-42): a scipy
    CSR with rows = the mode's index and columns = the other modes'
    linearized index, times its transpose.  Host set-up work, once per fit;
    float64."""
    from scipy.sparse import csr_matrix
    idx = X.indices.cpu().numpy()
    val = X.values.cpu().numpy().astype(np.float64)
    rows = idx[:, mode].astype(np.int64)
    rid = np.zeros(len(val), np.int64)
    ncols = 1
    for d in range(len(shape)):
        if d != mode:
            rid = rid * shape[d] + idx[:, d]
            ncols *= int(shape[d])
    S = csr_matrix((val, (rows, rid)), shape=(int(shape[mode]), ncols))
    return np.asarray((S @ S.T).todense())


def cmtf_nvecs(spec: ProblemSpec, data: ProblemData, n: int, r: int
               ) -> torch.Tensor:
    """Leading r eigenvectors of the Gram of the concatenated mode-n
    unfoldings of every CP dataset holding mode n (cmtf_nvecs.m:34-56),
    dense or COO, on the data's device."""
    Y = None
    for p, ds in enumerate(spec.datasets):
        if n in ds.modes and ds.model == CP:
            X = data.objects[p]
            local = ds.modes.index(n)
            if isinstance(X, SparseTensor):
                sizes = tuple(spec.mode_sizes[m] for m in ds.modes)
                G = torch.as_tensor(_coo_unfolding_gram(X, sizes, local),
                                    dtype=X.dtype, device=X.device)
            else:
                U = unfold(X, local)
                G = U @ U.T
            Y = G if Y is None else Y + G
    if Y is None:
        raise ValueError(f"nvecs: mode {n} not found in any CP dataset")
    return top_eigvecs(Y, r)


def delta_shape(spec: ProblemSpec, data: ProblemData, cid: int, fac,
                delta_shapes: dict | None = None) -> tuple:
    """Shape of coupling cid's Delta (init_coupled_AOADMM_CMTF.m:132-169):
    fac[m1] for type 0, (rows of H, R) for 1, (I, columns of H) for 2,
    (columns of H, R) for 3, (I, rows of H) for 4; type 5 has no shape to
    derive and takes delta_shapes[cid] (ValueError without it)."""
    cmodes = spec.coupled_modes_of(cid)
    m1 = cmodes[0]
    ctype = spec.coupling.coupling_type[cid - 1]
    _check_ctype(ctype)
    rows, R = fac[m1].shape
    H1 = data.coupl_trafo[m1] if data.coupl_trafo else None
    if ctype == 0:
        return (rows, R)
    if ctype == 1:
        return (H1.shape[0], R)
    if ctype == 2:
        return (rows, H1.shape[1])
    if ctype == 3:
        return (H1.shape[1], R)
    if ctype == 4:
        return (rows, H1.shape[0])
    if delta_shapes is None or cid not in delta_shapes:
        raise ValueError(
            "coupling type 5 requires delta_shapes={cid: (rows, cols)}")
    return tuple(delta_shapes[cid])


def dual_shape(spec: ProblemSpec, cid: int, m: int, fac, dshape: tuple
               ) -> tuple:
    """Shape of mode m's coupling dual: Delta's for types 0, 1 and 2 (type
    0: fac[m1]'s), fac[m]'s for 3 and 4, (rows of Delta, R_m) for 5."""
    ctype = spec.coupling.coupling_type[cid - 1]
    if ctype in (0, 1, 2):
        return dshape
    if ctype in (3, 4):
        return tuple(fac[m].shape)
    return (dshape[0], fac[m].shape[-1])


def init_coupled(spec: ProblemSpec, data: ProblemData,
                 init_options: InitOptions, generator: torch.Generator | None = None,
                 seed: int = 0, delta_shapes: dict | None = None) -> SolverState:
    """Build a full initial SolverState (factors, constraint auxiliaries and
    duals, coupling Delta and duals) — init_coupled_AOADMM_CMTF.m:37-169.

    generator: the source of every draw; when None, one is seeded with
    `seed`.  delta_shapes: {cid: (rows, cols)}, the Delta shape of each
    type-5 coupling (the reference passes the true Delta; ValueError
    without it).  The state takes the dtype and device of the first data
    object (of its values, for a SparseTensor)."""
    dt = data.objects[0].dtype
    dev = data.objects[0].device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    nb = spec.nb_modes
    ncpl = spec.coupling.n_couplings
    P = len(spec.datasets)
    distr = init_options.distr or tuple("rand" for _ in range(nb))
    if len(distr) != nb:
        raise ValueError(
            f"init_options.distr has {len(distr)} entries for {nb} modes")
    if init_options.lambdas_init:
        li = init_options.lambdas_init
        if len(li) != P:
            raise ValueError(
                f"init_options.lambdas_init has {len(li)} entries for "
                f"{P} datasets")
        for p, lam in enumerate(li):
            if len(lam) != spec.datasets[p].rank:
                raise ValueError(
                    f"init_options.lambdas_init[{p}] has length {len(lam)} "
                    f"but dataset {p} has rank {spec.datasets[p].rank} "
                    "(DatasetSpec.rank is authoritative and they must agree)")
    def draw(m, shape):
        return _sampler(distr[m])(generator, shape, dt, dev)

    def rand(shape):
        return torch.rand(shape, generator=generator, dtype=dt, device=dev)

    fac = [None] * nb
    for p, ds in enumerate(spec.datasets):
        if ds.model != CP:
            raise NotImplementedError(
                "PARAFAC2 initialization comes with slice 4 (ROADMAP.md)")
        for n in ds.modes:
            if init_options.nvecs:
                fac[n] = cmtf_nvecs(spec, data, n, ds.rank).to(dt)
                continue
            A = draw(n, (spec.mode_sizes[n], ds.rank))
            fac[n] = _normalize_cols(A) if init_options.normalize else A

    from matlab_code_tpu_torch.models.solver import build_proxes
    proxes, _ = build_proxes(spec)
    constraint_fac = [None] * nb
    constraint_dual = [None] * nb
    for p, ds in enumerate(spec.datasets):
        for n in ds.modes:
            if spec.is_constrained(n):
                constraint_fac[n] = proxes[n](draw(n, fac[n].shape), 1.0)
                constraint_dual[n] = rand(fac[n].shape)

    coupling_fac = [None] * ncpl
    coupling_dual = [None] * nb
    for cid in range(1, ncpl + 1):
        dshape = delta_shape(spec, data, cid, fac, delta_shapes)
        coupling_fac[cid - 1] = rand(dshape)
        for m in spec.coupled_modes_of(cid):
            coupling_dual[m] = rand(dual_shape(spec, cid, m, fac, dshape))

    return SolverState(
        fac=tuple(fac), constraint_fac=tuple(constraint_fac),
        constraint_dual_fac=tuple(constraint_dual),
        coupling_fac=tuple(coupling_fac),
        coupling_dual_fac=tuple(coupling_dual),
        P=(None,) * P, DeltaB=(None,) * P, mu_DeltaB=(None,) * P)
