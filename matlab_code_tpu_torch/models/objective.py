"""Objective / residual-stream evaluation (CMTF_AOADMM_func_eval,
cmtf_fun_AOADMM.m:1213-1363), counterpart of the CP-Frobenius part of
matlab_code_tpu/models/objective.py: data terms, the constraints'
regularizer terms (ops/prox.make_prox's reg), ridge, and the coupling
gaps of types 0-5.

Returns the four streams (f_tensors, f_couplings, f_constraints,
f_PAR2_couplings) as 0-d tensors.  The data term reads the cached MTTKRP
of the last updated mode (no extra data pass); the fresh branch (iteration
0) runs one MTTKRP per dataset, dense or sparse COO.
"""
from __future__ import annotations

import torch

from matlab_code_tpu_torch.models.admm import _check_ctype
from matlab_code_tpu_torch.ops.tensor import (
    gram, hadamard_grams, mttkrp, mttkrp_sparse)
from matlab_code_tpu_torch.problem import (
    CP, ProblemData, ProblemSpec, SparseTensor)

_fro = torch.linalg.norm


def _mean_nonzero(vals):
    """sum / count of nonzero entries, or the plain sum when all are zero
    (cmtf_fun_AOADMM.m:1327-1329, 1346-1348)."""
    arr = torch.stack(vals)
    nnz = torch.sum(arr != 0)
    return torch.where(nnz > 0, torch.sum(arr) / torch.clamp(nnz, min=1),
                       torch.sum(arr))


def func_eval(spec: ProblemSpec, data: ProblemData, state, grams,
              znorm_consts, reg_fns, cached=None, options=None):
    """The four objective streams.  cached: None (fresh eval) or
    {p: (last_mttkrp, last_had, last_local_mode)} for CP-Frobenius datasets."""
    like = state.fac[0]
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    fps = []
    for p, ds in enumerate(spec.datasets):
        X = data.objects[p]
        if ds.model != CP or ds.loss != "Frobenius":
            raise NotImplementedError(
                f"func_eval is ported for CP datasets with Frobenius loss; "
                f"dataset {p} is {ds.model}/{ds.loss} (PARAFAC2: slice 4, "
                "other losses: slice 5)")
        if data.miss[p] is not None:
            raise NotImplementedError(
                "missing data (EM imputation) comes with slice 6 (ROADMAP.md)")
        if cached is not None and p in cached:
            last_mk, last_had, last_m = cached[p]
            mlast = ds.modes[last_m]
            f2 = torch.sum(last_mk * state.fac[mlast])
            f3 = torch.sum(last_had * grams[mlast])
            fp = ds.weight * (znorm_consts[p] - 2.0 * f2 + f3)
        else:
            facs = [state.fac[j] for j in ds.modes]
            if isinstance(X, SparseTensor):
                mk = mttkrp_sparse(X.indices, X.values, facs, 0,
                                   facs[0].shape[0],
                                   plan=None if X.plans is None else X.plans[0])
            else:
                mk = mttkrp(X, facs, 0)
            f2 = torch.sum(mk * facs[0])
            f3 = torch.sum(hadamard_grams([gram(U) for U in facs]))
            fp = ds.weight * (znorm_consts[p] - 2.0 * f2 + f3)
        fps.append(fp)
    f_tensors = sum(fps)

    for m in range(spec.nb_modes):
        rf = reg_fns[m] if reg_fns else None
        if rf is not None:
            f_tensors = f_tensors + rf(state.fac[m])
    if spec.ridge is not None:
        for m in range(spec.nb_modes):
            if spec.ridge[m]:
                f_tensors = f_tensors + spec.ridge[m] * torch.sum(state.fac[m] ** 2)

    # coupling gaps (cmtf_fun_AOADMM.m:1302-1329)
    cps = []
    for cid in range(1, spec.coupling.n_couplings + 1):
        ctype = spec.coupling.coupling_type[cid - 1]
        _check_ctype(ctype)
        Delta = state.coupling_fac[cid - 1]
        acc = zero
        for mm in spec.coupled_modes_of(cid):
            fac = state.fac[mm]
            H = data.coupl_trafo[mm] if data.coupl_trafo else None
            if ctype == 0:
                acc = acc + _fro(fac - Delta) / _fro(fac)
            elif ctype in (1, 2):
                t = H @ fac if ctype == 1 else fac @ H
                acc = acc + _fro(t - Delta) / _fro(t)
            elif ctype == 3:
                acc = acc + _fro(fac - H @ Delta) / _fro(fac)
            elif ctype == 4:
                acc = acc + _fro(fac - Delta @ H) / _fro(fac)
            else:
                t = H @ fac
                acc = acc + _fro(t - Delta @ data.coupl_trafo2[mm]) / _fro(t)
        cps.append(acc)
    f_couplings = _mean_nonzero(cps) if cps else zero

    # constraint gaps (cmtf_fun_AOADMM.m:1331-1348)
    fcs = [_fro(state.fac[m] - state.constraint_fac[m]) / _fro(state.fac[m])
           for m in range(spec.nb_modes) if spec.is_constrained(m)]
    f_constraints = _mean_nonzero(fcs) if fcs else zero

    # no PARAFAC2 datasets: the internal coupling stream is zero
    return f_tensors, f_couplings, f_constraints, zero
