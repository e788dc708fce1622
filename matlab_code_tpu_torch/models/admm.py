"""Inner ADMM loops: constrained-only and coupled (coupling types 0-5),
counterpart of the CP part of matlab_code_tpu/models/admm.py
(cmtf_fun_AOADMM.m:591-1075).

The JAX package runs each inner loop as a lax.while_loop that exits on the
residuals.  Here it is an eager host loop with the same exit rule: the
condition `it <= MaxInnerIters and (residual > tol)` is tested before each
body, residuals start at inf, and the loop returns it - 1.  Each test after
the first reads two residuals from the device (one host sync, counted by
to_host).  PARAFAC2 modes (and their par2C coupling branches) come with
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
PORTED_COUPLING_TYPES = (0, 1, 2, 3, 4, 5)


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
        raise ValueError(f"coupling type {ctype} is not one of "
                         f"{PORTED_COUPLING_TYPES}")


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
    """One coupled-factor update for CP mode m (Frobenius loss): `solve`
    is linalg.sylvester_solver's for types 1 and 5 (B2 X + X B = A_inner,
    B the mode's normal matrix, B2 = rho/2 H^T H [+ rho/2 I]) and
    make_spd_solver's right solver for the other types."""
    Delta = state.coupling_fac[cid - 1]
    dual = state.coupling_dual_fac[m]
    H = data.coupl_trafo[m] if data.coupl_trafo else None
    if ctype in (1, 5):
        target = Delta if ctype == 1 else Delta @ data.coupl_trafo2[m]
        A_inner = A + 0.5 * rho * (H.T @ (target - dual))
        if constrained:
            A_inner = A_inner + 0.5 * rho * (
                state.constraint_fac[m] - state.constraint_dual_fac[m])
        return solve(A_inner)
    if ctype == 0:
        extra = Delta - dual
    elif ctype == 2:
        extra = (Delta - dual) @ H.T
    elif ctype == 3:
        extra = H @ Delta - dual
    else:  # 4
        extra = Delta @ H - dual
    A_inner = A + 0.5 * rho * extra
    if constrained:
        A_inner = A_inner + 0.5 * rho * (
            state.constraint_fac[m] - state.constraint_dual_fac[m])
    return solve(A_inner)


def _delta_update(spec, state, data, cmodes, cid, ctype, rhos):
    """Consensus Delta update for each coupling type (cmtf_fun_AOADMM.m
    :660-675, 737-749, 807-815, 872-881, 938-963, 1026-1054)."""
    Delta = state.coupling_fac[cid - 1]
    zero = torch.zeros((), dtype=Delta.dtype, device=Delta.device)
    if ctype in (0, 1, 2):
        num = torch.zeros_like(Delta)
        sum_rho = zero
        for jj in cmodes:
            r = rhos[jj]
            fac = state.fac[jj]
            if ctype == 1:
                fac = data.coupl_trafo[jj] @ fac
            elif ctype == 2:
                fac = fac @ data.coupl_trafo[jj]
            num = num + r * (fac + state.coupling_dual_fac[jj])
            sum_rho = sum_rho + r
        return num / sum_rho
    if ctype == 3:
        H0 = data.coupl_trafo[cmodes[0]]
        AA = torch.zeros((H0.shape[1], H0.shape[1]), dtype=Delta.dtype,
                         device=Delta.device)
        BB = torch.zeros((H0.shape[1], state.fac[cmodes[0]].shape[1]),
                         dtype=Delta.dtype, device=Delta.device)
        for jj in cmodes:
            H = data.coupl_trafo[jj]
            r = rhos[jj]
            AA = AA + H.T @ (r * H)
            BB = BB + H.T @ (r * (state.fac[jj] + state.coupling_dual_fac[jj]))
        return solve(AA, BB)
    if ctype == 4:
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
    # type 5: the reference weights every term with rho of the LAST coupled
    # mode (its leftover loop variable, cmtf_fun_AOADMM.m:1032); kept
    rhoC = rhos[cmodes[-1]]
    H20 = data.coupl_trafo2[cmodes[0]]
    D2 = H20.shape[0]
    AA = torch.zeros((D2, D2), dtype=Delta.dtype, device=Delta.device)
    BB = torch.zeros((data.coupl_trafo[cmodes[0]].shape[0], D2),
                     dtype=Delta.dtype, device=Delta.device)
    for jj in cmodes:
        H, H2 = data.coupl_trafo[jj], data.coupl_trafo2[jj]
        AA = AA + rhoC * (H2 @ H2.T)
        BB = BB + rhoC * (H @ state.fac[jj]
                          + state.coupling_dual_fac[jj]) @ H2.T
    return solve(AA.T, BB.T).T


def _dual_update(spec, state, data, m, cid, ctype):
    Delta = state.coupling_fac[cid - 1]
    dual = state.coupling_dual_fac[m]
    H = data.coupl_trafo[m] if data.coupl_trafo else None
    fac = state.fac[m]
    if ctype == 0:
        return dual + fac - Delta
    if ctype == 1:
        return dual + H @ fac - Delta
    if ctype == 2:
        return dual + fac @ H - Delta
    if ctype == 3:
        return dual + fac - H @ Delta
    if ctype == 4:
        return dual + fac - Delta @ H
    return dual + H @ fac - Delta @ data.coupl_trafo2[m]


def _coupling_transform(spec, state, data, m, ctype):
    """transform(fac) whose gap to Delta defines the primal residual."""
    fac = state.fac[m]
    if ctype in (0, 3, 4):
        return fac
    H = data.coupl_trafo[m]
    if ctype in (1, 5):
        return H @ fac
    return fac @ H


def eval_res_coupling(spec, state, data, cmodes, cid, ctype, oldDelta):
    """Relative primal/dual coupling residuals (cmtf_fun_AOADMM.m:1099-1210)."""
    Delta = state.coupling_fac[cid - 1]
    pr = 0.0
    dr = 0.0
    for mm in cmodes:
        t = _coupling_transform(spec, state, data, mm, ctype)
        if ctype in (0, 1, 2):
            gap = t - Delta
            nrm = _fro(t) if ctype in (1, 2) else _fro(state.fac[mm])
            dgap = Delta - oldDelta
        elif ctype == 3:
            H = data.coupl_trafo[mm]
            gap = state.fac[mm] - H @ Delta
            nrm = _fro(state.fac[mm])
            dgap = H @ (Delta - oldDelta)
        elif ctype == 4:
            H = data.coupl_trafo[mm]
            gap = state.fac[mm] - Delta @ H
            nrm = _fro(state.fac[mm])
            dgap = (Delta - oldDelta) @ H
        else:  # 5
            H, H2 = data.coupl_trafo[mm], data.coupl_trafo2[mm]
            gap = H @ state.fac[mm] - Delta @ H2
            nrm = _fro(state.fac[mm])
            dgap = (Delta - oldDelta) @ H2
        pr = pr + _fro(gap) / nrm
        dr = dr + _safe_div(_fro(dgap), _fro(state.coupling_dual_fac[mm]))
    return pr / len(cmodes), dr / len(cmodes)


def admm_coupled(spec: ProblemSpec, state: SolverState, data, cmodes, cid,
                 ctype, As, rhos, options, proxes, solvers):
    """Coupled-ADMM loop for coupling types 0-5 (cmtf_fun_AOADMM.m:625-1075)
    on CP modes.  As/rhos/solvers: dicts keyed by mode; solvers holds the
    solvers prebuilt once an outer iteration: make_spd_solver's right
    solvers (types 0, 2, 3, 4) or linalg.sylvester_solver's (types 1, 5).
    Returns (state, inner_iters)."""
    _check_ctype(ctype)
    for mm in cmodes:
        if spec.mode_role(mm) != "cp":
            raise NotImplementedError(
                f"coupled mode {mm} is a PARAFAC2 mode: PARAFAC2 (and the "
                "par2C coupling branches) come with slice 4 (ROADMAP.md)")
        if spec.datasets[spec.which_p(mm)].loss != "Frobenius":
            raise NotImplementedError(
                "admm_coupled is ported for Frobenius loss; other losses come "
                "with slice 5 (ROADMAP.md)")
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
