"""Inner ADMM loops: constrained-only and coupled (coupling types 0 and 4),
counterpart of the main-path part of matlab_code_tpu/models/admm.py
(cmtf_fun_AOADMM.m:591-1075).

The JAX package runs each inner loop as a lax.while_loop that exits on the
residuals.  Here it is an eager host loop with the same exit rule: the
condition `it <= MaxInnerIters and (residual > tol)` is tested before each
body, residuals start at inf, and the loop returns it - 1.  Each test after
the first reads two residuals from the device (one host sync, counted by
to_host).  Coupling types 1, 2, 3 and 5 come with slice 3, PARAFAC2 with
slice 4 and non-Frobenius losses with slice 5.
"""
from __future__ import annotations

import math

import torch

from matlab_code_tpu_torch.ops.linalg import (
    chol_lower, solve, solve_with_chol, spd_inverse_from_chol)
from matlab_code_tpu_torch.problem import ProblemSpec
from matlab_code_tpu_torch.state import SolverState, tuple_set

_fro = torch.linalg.norm
PORTED_COUPLING_TYPES = (0, 4)


def to_host(t):
    """t.tolist(): one device-to-host copy, a sync on CUDA.  Every read of a
    device value that steers the host loops goes through here and is counted
    in to_host.calls, so a run can report its syncs per outer iteration."""
    to_host.calls += 1
    return t.tolist()


to_host.calls = 0


def _safe_div(a, b):
    """a/b, but a when b == 0 (the residual-scaling convention at
    cmtf_fun_AOADMM.m:1087-1092)."""
    return torch.where(b > 0, a / torch.where(b > 0, b, torch.ones_like(b)), a)


def _check_ctype(ctype: int) -> None:
    if ctype not in PORTED_COUPLING_TYPES:
        raise NotImplementedError(
            f"coupling type {ctype} is not ported yet: the port carries types "
            f"{PORTED_COUPLING_TYPES}; types 1, 2, 3 and 5 come with slice 3 "
            "(ROADMAP.md, 'the rest of the CP surface')")


def make_update_constraint(spec: ProblemSpec, proxes):
    """Z = prox(fac + mu, rho); mu += fac - Z (cmtf_fun_AOADMM.m:1420-1429)."""
    def upd(state: SolverState, m: int, rho):
        oldZ = state.constraint_fac[m]
        Z = proxes[m](state.fac[m] + state.constraint_dual_fac[m], rho)
        dual = state.constraint_dual_fac[m] + state.fac[m] - Z
        state = state.replace(
            constraint_fac=tuple_set(state.constraint_fac, m, Z),
            constraint_dual_fac=tuple_set(state.constraint_dual_fac, m, dual))
        return state, oldZ
    return upd


def _resolve_inner_solve(options, device: torch.device) -> str:
    """'auto' is 'chol' on the CPU (the JAX CPU path's arithmetic) and
    'inverse' on CUDA: one R x R inverse per outer iteration turns every
    inner solve into one small matmul instead of two triangular-solve
    launches (PERF.md)."""
    method = options.inner_solve
    if method not in ("auto", "chol", "inverse", "newton"):
        raise ValueError(f"inner_solve must be 'auto'|'chol'|'inverse'"
                         f"|'newton', got {method!r}")
    if method == "newton":
        raise NotImplementedError(
            "inner_solve='newton' (K-batched PARAFAC2 systems) comes with "
            "slice 4 (ROADMAP.md, PARAFAC2)")
    if method == "auto":
        return "inverse" if device.type == "cuda" else "chol"
    return method


def _chol_rcond_bad(L, tol: float):
    """Ill-conditioning flag of a Cholesky factor: the rcond estimate
    (min/max diagonal)^2 below tol, or non-finite (chol_lower returns NaNs
    for a matrix that is not positive definite)."""
    d = torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))
    r = (torch.min(d) / torch.max(d)) ** 2
    return ~torch.isfinite(r) | (r < tol)


def make_spd_solver(Bmat, options, illtol: float = 0.0):
    """Inner-ADMM solver for the assembled SPD normal matrix, built once per
    outer iteration.  Returns (right, illc): right(A) solves X B = A (the
    reference's (A/L')/L, cmtf_fun_AOADMM.m:608-609); illc is the
    ill-conditioning flag (a 0-d tensor; False when illtol == 0)."""
    method = _resolve_inner_solve(options, Bmat.device)
    L = chol_lower(Bmat)
    if illtol > 0:
        illc = _chol_rcond_bad(L, illtol)
    else:
        illc = torch.zeros((), dtype=torch.bool, device=Bmat.device)
    if method == "chol":
        return (lambda A: solve_with_chol(L, A)), illc
    Binv = spd_inverse_from_chol(L)
    return (lambda A: A @ Binv), illc


def eval_res_constr(spec: ProblemSpec, state: SolverState, modes, oldZ: dict):
    """Relative primal/dual constraint residuals averaged over `modes`
    (cmtf_fun_AOADMM.m:1079-1096)."""
    pr = 0.0
    dr = 0.0
    for mm in modes:
        fac, Z = state.fac[mm], state.constraint_fac[mm]
        pr = pr + _fro(fac - Z) / _fro(fac)
        scaling = _fro(state.constraint_dual_fac[mm])
        dr = dr + _safe_div(_fro(Z - oldZ[mm]), scaling)
    return pr / len(modes), dr / len(modes)


def admm_constrained_only(spec: ProblemSpec, state: SolverState, m: int, p: int,
                          A, solve, rho, options, proxes):
    """Constrained, uncoupled CP mode (cmtf_fun_AOADMM.m:591-623), Frobenius
    loss.  solve: right solver from make_spd_solver.  Returns (state,
    inner_iters)."""
    if spec.datasets[p].loss != "Frobenius" or spec.mode_role(m) != "cp":
        raise NotImplementedError(
            "admm_constrained_only is ported for CP modes with Frobenius loss; "
            "PARAFAC2 comes with slice 4 and other losses with slice 5")
    upd = make_update_constraint(spec, proxes)
    it = 1
    pr = dr = math.inf
    while it <= options.MaxInnerIters and (
            it == 1 or to_host((pr > options.innerRelPrTol_constr)
                               | (dr > options.innerRelDualTol_constr))):
        A_inner = A + 0.5 * rho * (
            state.constraint_fac[m] - state.constraint_dual_fac[m])
        state = state.replace(fac=tuple_set(state.fac, m, solve(A_inner)))
        state, oldZ = upd(state, m, rho)
        pr, dr = eval_res_constr(spec, state, (m,), {m: oldZ})
        it += 1
    return state, it - 1


def _factor_update_case(spec, state, data, m, cid, ctype, A, rho,
                        constrained, solve):
    """One coupled-factor update for mode m (Frobenius loss), ctypes 0/4."""
    _check_ctype(ctype)
    Delta = state.coupling_fac[cid - 1]
    dual = state.coupling_dual_fac[m]
    if ctype == 0:
        extra = Delta - dual
    else:
        extra = Delta @ data.coupl_trafo[m] - dual
    A_inner = A + 0.5 * rho * extra
    if constrained:
        A_inner = A_inner + 0.5 * rho * (
            state.constraint_fac[m] - state.constraint_dual_fac[m])
    return solve(A_inner)


def _delta_update(spec, state, data, cmodes, cid, ctype, rhos):
    """Consensus Delta update (cmtf_fun_AOADMM.m:660-675, 938-963)."""
    _check_ctype(ctype)
    Delta = state.coupling_fac[cid - 1]
    if ctype == 0:
        num = torch.zeros_like(Delta)
        sum_rho = 0.0
        for jj in cmodes:
            r = rhos[jj]
            num = num + r * (state.fac[jj] + state.coupling_dual_fac[jj])
            sum_rho = sum_rho + r
        return num / sum_rho
    H0 = data.coupl_trafo[cmodes[0]]
    D = H0.shape[0]
    AA = torch.zeros((D, D), dtype=Delta.dtype, device=Delta.device)
    BB = torch.zeros((state.fac[cmodes[0]].shape[0], D), dtype=Delta.dtype,
                     device=Delta.device)
    for jj in cmodes:
        H = data.coupl_trafo[jj]
        r = rhos[jj]
        AA = AA + r * (H @ H.T)
        BB = BB + (r * (state.fac[jj] + state.coupling_dual_fac[jj])) @ H.T
    # Delta AA = BB, solved with the transpose as in the JAX package
    return solve(AA.T, BB.T).T


def _dual_update(spec, state, data, m, cid, ctype):
    _check_ctype(ctype)
    Delta = state.coupling_fac[cid - 1]
    dual = state.coupling_dual_fac[m]
    fac = state.fac[m]
    if ctype == 0:
        return dual + fac - Delta
    return dual + fac - Delta @ data.coupl_trafo[m]


def _coupling_transform(spec, state, data, m, ctype):
    """transform(fac) whose gap to Delta defines the primal residual: the
    factor itself for types 0 and 4."""
    _check_ctype(ctype)
    return state.fac[m]


def eval_res_coupling(spec, state, data, cmodes, cid, ctype, oldDelta):
    """Relative primal/dual coupling residuals (cmtf_fun_AOADMM.m:1099-1210)."""
    _check_ctype(ctype)
    Delta = state.coupling_fac[cid - 1]
    pr = 0.0
    dr = 0.0
    for mm in cmodes:
        fac = _coupling_transform(spec, state, data, mm, ctype)
        if ctype == 0:
            gap = fac - Delta
            dgap = Delta - oldDelta
        else:
            H = data.coupl_trafo[mm]
            gap = fac - Delta @ H
            dgap = (Delta - oldDelta) @ H
        pr = pr + _fro(gap) / _fro(fac)
        dr = dr + _safe_div(_fro(dgap), _fro(state.coupling_dual_fac[mm]))
    return pr / len(cmodes), dr / len(cmodes)


def admm_coupled(spec: ProblemSpec, state: SolverState, data, cmodes, cid,
                 ctype, As, rhos, options, proxes, solvers):
    """Coupled-ADMM loop for coupling types 0 and 4
    (cmtf_fun_AOADMM.m:625-700, 884-983).  As/rhos/solvers: dicts keyed by
    mode; solvers holds the right solvers prebuilt by make_spd_solver.
    Returns (state, inner_iters)."""
    _check_ctype(ctype)
    for mm in cmodes:
        if spec.mode_role(mm) != "cp" or \
                spec.datasets[spec.which_p(mm)].loss != "Frobenius":
            raise NotImplementedError(
                "admm_coupled is ported for CP modes with Frobenius loss; "
                "PARAFAC2 comes with slice 4 and other losses with slice 5")
    upd = make_update_constraint(spec, proxes)
    constrained_modes = tuple(m for m in cmodes if spec.is_constrained(m))
    it = 1
    prc = drc = prk = drk = math.inf
    while it <= options.MaxInnerIters and (
            it == 1 or to_host((prk > options.innerRelPrTol_coupl)
                               | (prc > options.innerRelPrTol_constr)
                               | (drk > options.innerRelDualTol_coupl)
                               | (drc > options.innerRelDualTol_constr))):
        for mm in cmodes:
            fac = _factor_update_case(
                spec, state, data, mm, cid, ctype, As[mm], rhos[mm],
                spec.is_constrained(mm), solvers[mm])
            state = state.replace(fac=tuple_set(state.fac, mm, fac))
        oldDelta = state.coupling_fac[cid - 1]
        Delta = _delta_update(spec, state, data, cmodes, cid, ctype, rhos)
        state = state.replace(
            coupling_fac=tuple_set(state.coupling_fac, cid - 1, Delta))
        oldZ = {}
        for mm in cmodes:
            nd = _dual_update(spec, state, data, mm, cid, ctype)
            state = state.replace(
                coupling_dual_fac=tuple_set(state.coupling_dual_fac, mm, nd))
            if spec.is_constrained(mm):
                state, oldZ[mm] = upd(state, mm, rhos[mm])
        prk, drk = eval_res_coupling(spec, state, data, cmodes, cid, ctype,
                                     oldDelta)
        if constrained_modes:
            prc, drc = eval_res_constr(spec, state, constrained_modes, oldZ)
        else:
            prc = drc = 0.0
        it += 1
    return state, it - 1
