"""Initialization of the solver state (init_coupled_AOADMM_CMTF.m),
counterpart of matlab_code_tpu/models/init.py: random draws or spectral
('nvecs') factors, PARAFAC2's padded Bk with P, DeltaB and mu_DeltaB,
constraint auxiliaries through every prox, coupling Delta and duals for
types 0-5.

Draws come from an explicit torch.Generator, in the JAX package's order
(factors per dataset and mode, then constraint auxiliaries and duals, then
couplings).  torch and jax.random give different numbers from the same
seed, so a run that must match the JAX package moves its init state across
with convert.state_from_numpy.  nvecs factors take no draw and match the
JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from matlab_code_tpu_torch.models.admm import _check_ctype
from matlab_code_tpu_torch.ops.linalg import top_eigvecs
from matlab_code_tpu_torch.ops.tensor import unfold
from matlab_code_tpu_torch.options import InitOptions
from matlab_code_tpu_torch.problem import (
    CP, PAR2, ProblemData, ProblemSpec, SparseTensor)
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
    """Build a full initial SolverState (factors, PARAFAC2 P, DeltaB and
    mu_DeltaB, constraint auxiliaries and duals, coupling Delta and duals)
    — init_coupled_AOADMM_CMTF.m:37-169.  A PARAFAC2 Bk mode is (K, Jmax,
    R), zero past each slice's J_k rows, as are its P, mu and constraint
    auxiliaries.

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

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    fac = [None] * nb
    Pfac, DeltaB, mu_DeltaB = [None] * P, [None] * P, [None] * P
    for p, ds in enumerate(spec.datasets):
        R = ds.rank
        for n in ds.modes:
            local = ds.modes.index(n)
            if ds.model == PAR2 and local == 1:
                K, Jmax = spec.par2_K(p), spec.par2_Jmax(p)
                DeltaB[p] = rand((R, R))
                Bs, Ps, mus = zeros((K, Jmax, R)), zeros((K, Jmax, R)), \
                    zeros((K, Jmax, R))
                for k, J in enumerate(spec.par2_slice_sizes(p)):
                    if init_options.nvecs:
                        M = data.objects[p].slices[k, :, :J].T   # (J, I)
                        Bk = top_eigvecs(M @ M.T, R)
                    else:
                        Bk = draw(n, (J, R))
                        if init_options.normalize:
                            Bk = _normalize_cols(Bk)
                    Bs[k, :J] = Bk
                    Ps[k, :J] = torch.eye(J, R, dtype=dt, device=dev)
                    mus[k, :J] = rand((J, R))
                fac[n], Pfac[p], mu_DeltaB[p] = Bs, Ps, mus
            elif ds.model == PAR2 and local == 0 and init_options.nvecs:
                # the Gram of the horizontally concatenated slices (init
                # :54-60); padded columns are zero and add nothing
                Xs = data.objects[p].slices
                fac[n] = top_eigvecs(torch.einsum("kij,klj->il", Xs, Xs), R)
            elif ds.model == PAR2 and local == 2 and init_options.nvecs:
                fac[n] = torch.ones((spec.mode_sizes[n], R), dtype=dt,
                                    device=dev)
            elif init_options.nvecs:
                fac[n] = cmtf_nvecs(spec, data, n, R).to(dt)
            else:
                A = draw(n, (spec.mode_sizes[n], R))
                fac[n] = _normalize_cols(A) if init_options.normalize else A

    from matlab_code_tpu_torch.models.solver import build_proxes
    proxes, _ = build_proxes(spec)
    constraint_fac = [None] * nb
    constraint_dual = [None] * nb
    for p, ds in enumerate(spec.datasets):
        for n in ds.modes:
            if not spec.is_constrained(n):
                continue
            if ds.model == PAR2 and ds.modes.index(n) == 1:
                Zs, duals = zeros(fac[n].shape), zeros(fac[n].shape)
                tpar2 = spec.constraints[n].kind == "tPARAFAC2"
                for k, J in enumerate(spec.par2_slice_sizes(p)):
                    z = draw(n, (J, ds.rank))
                    Zs[k, :J] = z if tpar2 else proxes[n](z, 1.0)  # init:110-112
                    duals[k, :J] = rand((J, ds.rank))
                constraint_fac[n], constraint_dual[n] = Zs, duals
            else:
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
        P=tuple(Pfac), DeltaB=tuple(DeltaB), mu_DeltaB=tuple(mu_DeltaB))
