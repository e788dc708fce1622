"""Inner ADMM loops: constrained-only, PARAFAC2-Bk and coupled (coupling
types 0-5), counterpart of matlab_code_tpu/models/admm.py
(cmtf_fun_AOADMM.m:509-1075).

The JAX package runs each inner loop as a lax.while_loop that exits on the
residuals.  Here it is an eager host loop with the same exit rule: the
condition `it <= MaxInnerIters and (residual > tol)` is tested before each
body, residuals start at inf, and the loop returns it - 1.  Each test after
the first reads one flag from the device (one host sync, counted by
to_host).  The PARAFAC2 per-slice work (Bk systems, polar factors, the
slice-wise prox, par2C rows) is batched over the K slices.  A mode of a
non-Frobenius dataset takes its factor step by L-BFGS-B
(models/lbfgs_bridge.py) inside the same loops.

Each loop is a step function that run_inner repeats.  Under
fit_multistart's start axis (models/multistart.py: one start's code under
torch.func.vmap) run_inner keeps the JAX while_loop's semantics under
vmap: each start steps while its own exit test held, a start that stopped
keeps its values, and the read a step is whether any start still steps.
"""
from __future__ import annotations

import math
import time

import torch

from matlab_code_tpu_torch.ops.lanes import any_lane, keep, on_start_axis
from matlab_code_tpu_torch.ops.linalg import (
    chol_lower, polar_orth, polar_orth_ns, solve, solve_spd_left,
    solve_with_chol, spd_inverse_from_chol, spd_inverse_newton)
from matlab_code_tpu_torch.problem import ProblemSpec
from matlab_code_tpu_torch.state import SolverState, tuple_set

_fro = torch.linalg.norm
PORTED_COUPLING_TYPES = (0, 1, 2, 3, 4, 5)


def to_host(t):
    """t.tolist(): one device-to-host copy, a sync on CUDA.  Every read of a
    device value that steers the host loops goes through here and is counted
    in to_host.calls, and its host-clock seconds (the wait for the device
    included) in to_host.seconds, so a run can report its syncs per outer
    iteration and their share of the wall clock."""
    t0 = time.perf_counter()
    out = t.tolist()
    to_host.seconds += time.perf_counter() - t0
    to_host.calls += 1
    return out


to_host.calls = 0
to_host.seconds = 0.0


def run_inner(step, carry, options):
    """The inner loop: step(carry) -> (carry, go), go the exit test of the
    step's residuals on the device (True: step again).  As the JAX
    while_loop, at most options.MaxInnerIters steps, and the test is read
    (one to_host) before each step after the first.  Returns (carry, n),
    n the steps taken.

    Where the carry holds fit_multistart's start axis (ops/lanes.py), each
    start steps while its own test held at every step: the read is whether
    any start still steps (any_lane, one read a step whatever the number of
    starts), a start that stopped keeps its carry (lanes.keep), and n is
    each start's own count, a tensor.  Each step after the first gets the
    starts still stepping, step(carry, active), so a loop nested in the
    step (the lanes L-BFGS-B) moves only those."""
    if options.MaxInnerIters < 1:
        return carry, 0
    carry, go = step(carry)
    if not on_start_axis(go):
        it = 2
        while it <= options.MaxInnerIters and to_host(go):
            carry, go = step(carry)
            it += 1
        return carry, it - 1
    active = go
    n = torch.ones_like(go, dtype=torch.int32)
    it = 2
    while it <= options.MaxInnerIters and to_host(any_lane(active)):
        new, go = step(carry, active)
        carry = keep(active, new, carry)
        n = n + active.to(torch.int32)
        active = active & go
        it += 1
    return carry, n


def _safe_div(a, b):
    """a/b, but a when b == 0 (the residual-scaling convention at
    cmtf_fun_AOADMM.m:1087-1092)."""
    return torch.where(b > 0, a / torch.where(b > 0, b, torch.ones_like(b)), a)


def _check_ctype(ctype: int) -> None:
    if ctype not in PORTED_COUPLING_TYPES:
        raise ValueError(f"coupling type {ctype} is not one of "
                         f"{PORTED_COUPLING_TYPES}")


def make_update_constraint(spec: ProblemSpec, proxes):
    """Z = prox(fac + mu, rho); mu += fac - Z (cmtf_fun_AOADMM.m:1420-1429).
    A par2C mode uses max(rho) over its per-row penalties (:1423-1424)."""
    def upd(state: SolverState, m: int, rho):
        oldZ = state.constraint_fac[m]
        if spec.mode_role(m) == "par2_C":
            rho = torch.amax(rho)
        Z = proxes[m](state.fac[m] + state.constraint_dual_fac[m], rho)
        dual = state.constraint_dual_fac[m] + state.fac[m] - Z
        state = state.replace(
            constraint_fac=tuple_set(state.constraint_fac, m, Z),
            constraint_dual_fac=tuple_set(state.constraint_dual_fac, m, dual))
        return state, oldZ
    return upd


# what inner_solve='auto' and par2_polar='auto' resolve to on CUDA for the
# K-batched PARAFAC2 systems (PERF.md gives the timings behind them)
AUTO_BATCHED_SOLVE_CUDA = "inverse"
AUTO_POLAR_CUDA = "ns"


def _resolve_inner_solve(options, device: torch.device,
                         batched: bool = False) -> str:
    """'auto' is 'chol' on the CPU (the JAX CPU path's arithmetic); on CUDA
    'inverse' for an R x R system (one inverse per outer iteration turns
    every inner solve into one small matmul instead of two triangular-solve
    launches) and AUTO_BATCHED_SOLVE_CUDA for the K-batched PARAFAC2 ones
    (PERF.md)."""
    method = options.inner_solve
    if method not in ("auto", "chol", "inverse", "newton"):
        raise ValueError(f"inner_solve must be 'auto'|'chol'|'inverse'"
                         f"|'newton', got {method!r}")
    if method == "auto":
        if device.type != "cuda":
            return "chol"
        return AUTO_BATCHED_SOLVE_CUDA if batched else "inverse"
    return method


def _resolve_polar(options, device: torch.device) -> str:
    """options.par2_polar: 'auto' is 'svd' on the CPU (the JAX CPU path) and
    AUTO_POLAR_CUDA on CUDA (PERF.md)."""
    method = options.par2_polar
    if method not in ("auto", "svd", "ns"):
        raise ValueError(f"par2_polar must be 'auto'|'svd'|'ns', "
                         f"got {method!r}")
    if method == "auto":
        return AUTO_POLAR_CUDA if device.type == "cuda" else "svd"
    return method


def _chol_rcond_bad(L, tol: float):
    """Ill-conditioning flag of a Cholesky factor: the rcond estimate
    (min/max diagonal)^2 below tol, or non-finite (chol_lower returns NaNs
    for a matrix that is not positive definite)."""
    d = torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))
    r = (torch.min(d) / torch.max(d)) ** 2
    return ~torch.isfinite(r) | (r < tol)


def make_spd_solver(Bmat, options, illtol: float = 0.0, lmin=None):
    """Inner-ADMM solvers for the assembled SPD normal matrix (R x R, or a
    K-batch (K, R, R)), built once per outer iteration.  Returns (right,
    rowleft, illc): right(A) solves X B = A (the reference's (A/L')/L,
    cmtf_fun_AOADMM.m:608-609; A (I, R), or (K, J, R) against a batch);
    rowleft(A) solves the row systems B_k x_k = a_k, A (K, R) (the par2C
    rows, :602-606); illc is the ill-conditioning flag (a 0-d tensor;
    False when illtol == 0).  options.inner_solve: 'chol' factorizes and
    substitutes a call, 'inverse' inverts once through the factor,
    'newton' inverts by Newton-Hotelling matmuls (lmin: the + rho/2 I
    eigenvalue bound that sharpens its start)."""
    method = _resolve_inner_solve(options, Bmat.device, Bmat.dim() >= 3)
    if method == "newton":
        Binv, rcond = spd_inverse_newton(Bmat, lmin=lmin)
        if illtol > 0:
            illc = torch.any(~torch.isfinite(rcond) | (rcond < illtol))
        else:
            illc = torch.zeros((), dtype=torch.bool, device=Bmat.device)
        return ((lambda A: A @ Binv),
                (lambda A: (Binv @ A[..., None])[..., 0]), illc)
    L = chol_lower(Bmat)
    if illtol > 0:
        illc = _chol_rcond_bad(L, illtol)
    else:
        illc = torch.zeros((), dtype=torch.bool, device=Bmat.device)
    if method == "chol":
        return ((lambda A: solve_with_chol(L, A)),
                (lambda A: solve_spd_left(L, A[..., None])[..., 0]), illc)
    Binv = spd_inverse_from_chol(L)
    return ((lambda A: A @ Binv),
            (lambda A: (Binv @ A[..., None])[..., 0]), illc)


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
                          A, solve, rho, options, proxes, lbfgs_step=None,
                          data=None):
    """Constrained, uncoupled CP, PARAFAC2-A or par2C mode
    (cmtf_fun_AOADMM.m:591-623).  Frobenius loss: solve is
    make_spd_solver's right solver (its rowleft solver for a par2C mode,
    whose rows take their own rho).  Other losses: A and solve are None and
    each step runs lbfgs_step (models/lbfgs_bridge.make_lbfgs_step) on
    `data`.  Returns (state, inner_iters, lbfgsb_total, (pr, dr)): the
    L-BFGS-B iterations summed over the steps, and the last residuals."""
    upd = make_update_constraint(spec, proxes)
    frob = spec.datasets[p].loss == "Frobenius"
    rho_b = rho[:, None] if spec.mode_role(m) == "par2_C" else rho
    lb = 0

    def step(carry, active=None):
        nonlocal lb
        state = carry[0]
        if frob:
            A_inner = A + 0.5 * rho_b * (
                state.constraint_fac[m] - state.constraint_dual_fac[m])
            state = state.replace(fac=tuple_set(state.fac, m, solve(A_inner)))
        else:
            state, nit = lbfgs_step(state, data, constrained=True,
                                    coupling_type=-1, rho=rho, active=active)
            lb += nit
        state, oldZ = upd(state, m, rho)
        pr, dr = eval_res_constr(spec, state, (m,), {m: oldZ})
        return (state, pr, dr), ((pr > options.innerRelPrTol_constr)
                                 | (dr > options.innerRelDualTol_constr))

    (state, pr, dr), n = run_inner(step, (state, math.inf, math.inf),
                                   options)
    return state, n, lb, (pr, dr)


def _fro_slices(X):
    """Frobenius norm of each slice of a (K, J, R) stack."""
    return torch.linalg.vector_norm(X, dim=(1, 2))


def admm_b_parafac2(spec: ProblemSpec, state: SolverState, m: int, p: int,
                    A, solve, rho, options, proxes, constraint_active: bool,
                    sizes=None):
    """The PARAFAC2-specific inner loop (cmtf_fun_AOADMM.m:509-589), batched
    over the K slices.  A: (K, Jmax, R); solve: make_spd_solver's right
    solver of the K-batched systems; rho: (K,).  sizes: the true slice
    sizes J_k, or None for regular slices; ragged slices take the
    size-bucketed slice-wise prox, so no prox sees the zero padding.  Each
    step after the first reads its exit test, one flag over the four
    residuals, with one to_host.  Returns (state, inner_iters)."""
    K = spec.par2_K(p)
    constrained = spec.is_constrained(m) and constraint_active
    ragged = sizes is not None and len(set(sizes)) > 1
    if _resolve_polar(options, A.device) == "svd":
        polar = polar_orth
    else:
        polar = lambda M: polar_orth_ns(M, iters=options.par2_polar_iters)
    if constrained:
        upd_joint = spec.constraints[m].kind == "tPARAFAC2"
        prox = proxes[m]
    rho3 = rho[:, None, None]
    zero = torch.zeros((), dtype=A.dtype, device=A.device)

    def step(state, active=None):
        P_, DB, mu = state.P[p], state.DeltaB[p], state.mu_DeltaB[p]
        A_inner = A + 0.5 * rho3 * (P_ @ DB - mu)
        if constrained:
            A_inner = A_inner + 0.5 * rho3 * (
                state.constraint_fac[m] - state.constraint_dual_fac[m])
        facB = solve(A_inner)
        # P_k = polar((B_k + mu_k) DeltaB^T)  (cmtf_fun_AOADMM.m:532-534)
        oldP, oldDB = P_, DB
        P_ = polar((facB + mu) @ DB.T)
        # DeltaB = sum_k rho_k P_k^T (B_k + mu_k) / sum rho_k  (:536-544)
        DB = torch.einsum("k,kjr,kjs->rs", rho, P_, facB + mu) / torch.sum(rho)
        PDB = P_ @ DB
        mu = mu + facB - PDB
        state = state.replace(
            fac=tuple_set(state.fac, m, facB), P=tuple_set(state.P, p, P_),
            DeltaB=tuple_set(state.DeltaB, p, DB),
            mu_DeltaB=tuple_set(state.mu_DeltaB, p, mu))
        prc = drc = zero
        if constrained:
            oldZ = state.constraint_fac[m]
            V = facB + state.constraint_dual_fac[m]
            if upd_joint:
                Z = prox(V, rho)
            elif ragged:
                Z = prox_slicewise_ragged(prox, V, rho, sizes)
            else:
                Z = prox_slicewise(prox, V, rho)
            dual = state.constraint_dual_fac[m] + facB - Z
            state = state.replace(
                constraint_fac=tuple_set(state.constraint_fac, m, Z),
                constraint_dual_fac=tuple_set(state.constraint_dual_fac, m,
                                              dual))
            prc = torch.sum(_fro_slices(facB - Z) / _fro_slices(facB)) / K
            drc = torch.sum(_safe_div(_fro_slices(oldZ - Z),
                                      _fro_slices(dual))) / K
        prk = torch.sum(_fro_slices(facB - PDB) / _fro_slices(facB)) / K
        drk = torch.sum(_safe_div(_fro_slices(oldP @ oldDB - PDB),
                                  _fro_slices(mu))) / K
        return state, ((prk > options.innerRelPrTol_coupl)
                       | (prc > options.innerRelPrTol_constr)
                       | (drk > options.innerRelDualTol_coupl)
                       | (drc > options.innerRelDualTol_constr))

    return run_inner(step, state, options)


def prox_slicewise(prox, Bs, rho):
    """A matrix prox applied to each slice k of Bs (K, J, R) with its own
    rho_k (cmtf_fun_AOADMM.m:567-578), as one batched call: rho reaches the
    prox as a (K, 1, 1) tensor (ops/prox.py), so on the card the isotonic
    and TV kinds are one kernel launch each for the K slices."""
    return prox(Bs, rho[:, None, None])


def prox_slicewise_ragged(prox, Bs, rho, sizes):
    """The slice-wise prox on ragged padded slices: slice k is proxed on its
    true J_k rows only, as the reference's per-slice
    Z.prox_operators{m}(B{k}, rho(k)) on true-size matrices
    (cmtf_fun_AOADMM.m:567-578), and the padded rows stay exactly zero.
    On the card a prox whose kernels take the ragged stack (`takes_sizes`:
    monotone, unimodal, TV) is one launch for all slices; every other prox,
    and every prox on the CPU, runs as the JAX package does: slices bucketed
    by size, each bucket one batched prox call on exact shapes.  Bs (K,
    Jmax, R) padded; rho (K,); sizes the J_k."""
    if Bs.device.type == "cuda" and getattr(prox, "takes_sizes", False):
        return prox(Bs, rho[:, None, None], sizes=sizes)
    out = torch.zeros_like(Bs)
    buckets: dict[int, list[int]] = {}
    for k, J in enumerate(sizes):
        buckets.setdefault(int(J), []).append(k)
    for J, ks in sorted(buckets.items()):
        idx = torch.tensor(ks, device=Bs.device)
        out[idx, :J, :] = prox_slicewise(prox, Bs[idx, :J, :], rho[idx])
    return out


def _is_par2C(spec, m):
    return spec.mode_role(m) == "par2_C"


def _factor_update_case(spec, state, data, m, cid, ctype, A, rho,
                        constrained, solve):
    """One coupled-factor update for mode m (Frobenius loss).  `solve` is
    linalg.sylvester_solver's for a CP mode under types 1 and 5 (B2 X + X B
    = A_inner, B the mode's normal matrix, B2 = rho/2 H^T H [+ rho/2 I]);
    for a par2C mode under types 1 and 5 the solve of the kron-vectorized
    (K R) x (K R) system (cmtf_fun_AOADMM.m:710-722, 998-1010); else
    make_spd_solver's right solver (its rowleft solver for a par2C mode,
    whose rows take their own rho)."""
    Delta = state.coupling_fac[cid - 1]
    dual = state.coupling_dual_fac[m]
    H = data.coupl_trafo[m] if data.coupl_trafo else None
    par2C = _is_par2C(spec, m)
    if ctype in (1, 5):
        target = Delta if ctype == 1 else Delta @ data.coupl_trafo2[m]
        if par2C:
            # the row-major ravel of (K, R) is MATLAB's reshape(M', [], 1),
            # and kron(H, I)^T ravel(V) = ravel(H^T V): the JAX package's
            # product with the kron matrix, without building it
            K, R = state.fac[m].shape
            rhoC = torch.mean(rho)
            A_inner = A.reshape(K * R) + 0.5 * rhoC * (
                H.T @ (target - dual)).reshape(-1)
            if constrained:
                A_inner = A_inner + 0.5 * rhoC * (
                    state.constraint_fac[m] - state.constraint_dual_fac[m]
                ).reshape(-1)
            return solve(A_inner).reshape(K, R)
        A_inner = A + 0.5 * rho * (H.T @ (target - dual))
        if constrained:
            A_inner = A_inner + 0.5 * rho * (
                state.constraint_fac[m] - state.constraint_dual_fac[m])
        return solve(A_inner)
    rho_b = rho[:, None] if par2C else rho
    if ctype == 0:
        extra = Delta - dual
    elif ctype == 2:
        extra = (Delta - dual) @ H.T
    elif ctype == 3:
        extra = H @ Delta - dual
    else:  # 4
        extra = Delta @ H - dual
    A_inner = A + 0.5 * rho_b * extra
    if constrained:
        A_inner = A_inner + 0.5 * rho_b * (
            state.constraint_fac[m] - state.constraint_dual_fac[m])
    return solve(A_inner)


def _rowwise(spec, m, r):
    """A mode's rho as a weight of its rows: (K, 1) for a par2C mode."""
    return r[:, None] if _is_par2C(spec, m) else r


def _delta_update(spec, state, data, cmodes, cid, ctype, rhos):
    """Consensus Delta update for each coupling type (cmtf_fun_AOADMM.m
    :660-675, 737-749, 807-815, 872-881, 938-963, 1026-1054).  A par2C mode
    weights its rows by their own rho; under types 4 and 5 its rows then
    solve their own systems (AA + AA_PAR2_k)."""
    Delta = state.coupling_fac[cid - 1]
    kw = dict(dtype=Delta.dtype, device=Delta.device)
    zero = torch.zeros((), **kw)
    if ctype in (0, 2):
        num = torch.zeros_like(Delta)
        sum_rho = zero
        for jj in cmodes:
            r = rhos[jj]
            fac = state.fac[jj]
            if ctype == 2:
                fac = fac @ data.coupl_trafo[jj]
            num = num + _rowwise(spec, jj, r) * (fac + state.coupling_dual_fac[jj])
            sum_rho = sum_rho + r
        return num / (sum_rho[:, None] if sum_rho.dim() else sum_rho)
    if ctype == 1:
        num = torch.zeros_like(Delta)
        sum_rho = zero
        for jj in cmodes:
            r = torch.sum(rhos[jj])   # sum(rho{jj}) (cmtf_fun_AOADMM.m:742)
            num = num + r * (data.coupl_trafo[jj] @ state.fac[jj]
                             + state.coupling_dual_fac[jj])
            sum_rho = sum_rho + r
        return num / sum_rho
    if ctype == 3:
        H0 = data.coupl_trafo[cmodes[0]]
        AA = torch.zeros((H0.shape[1], H0.shape[1]), **kw)
        BB = torch.zeros((H0.shape[1], state.fac[cmodes[0]].shape[1]), **kw)
        for jj in cmodes:
            H = data.coupl_trafo[jj]
            r = _rowwise(spec, jj, rhos[jj])
            AA = AA + H.T @ (r * H)
            BB = BB + H.T @ (r * (state.fac[jj] + state.coupling_dual_fac[jj]))
        return solve(AA, BB)
    if ctype == 4:
        H0 = data.coupl_trafo[cmodes[0]]
        D = H0.shape[0]
        AA = torch.zeros((D, D), **kw)
        BB = torch.zeros((state.fac[cmodes[0]].shape[0], D), **kw)
        AA_PAR2 = None
        for jj in cmodes:
            H = data.coupl_trafo[jj]
            r = rhos[jj]
            if _is_par2C(spec, jj):
                AA_PAR2 = r[:, None, None] * (H @ H.T)[None]   # (K, D, D)
            else:
                AA = AA + r * (H @ H.T)
            BB = BB + (_rowwise(spec, jj, r) * (
                state.fac[jj] + state.coupling_dual_fac[jj])) @ H.T
        if AA_PAR2 is not None:
            # row-wise Delta(k,:) (AA + AA_PAR2_k) = BB(k,:), transposed
            sys = AA[None] + AA_PAR2
            return solve(sys.transpose(-1, -2), BB[:, :, None])[:, :, 0]
        # Delta AA = BB, solved with the transpose as in the JAX package
        return solve(AA.T, BB.T).T
    # type 5: the reference weights every term with rho of the LAST coupled
    # mode (its leftover loop variable, cmtf_fun_AOADMM.m:1032); kept
    rhoC = torch.mean(rhos[cmodes[-1]])
    H20 = data.coupl_trafo2[cmodes[0]]
    D2 = H20.shape[0]
    AA = torch.zeros((D2, D2), **kw)
    BB = torch.zeros((data.coupl_trafo[cmodes[0]].shape[0], D2), **kw)
    AA_PAR2 = None
    for jj in cmodes:
        H, H2 = data.coupl_trafo[jj], data.coupl_trafo2[jj]
        if _is_par2C(spec, jj):
            AA_PAR2 = rhos[jj][:, None, None] * (H2 @ H2.T)[None]
        else:
            AA = AA + rhoC * (H2 @ H2.T)
        BB = BB + rhoC * (H @ state.fac[jj]
                          + state.coupling_dual_fac[jj]) @ H2.T
    if AA_PAR2 is not None:
        sys = AA[None] + AA_PAR2
        return solve(sys.transpose(-1, -2), BB[:, :, None])[:, :, 0]
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
                 ctype, As, rhos, options, proxes, solvers, lbfgs_steps=None):
    """Coupled-ADMM loop for coupling types 0-5 (cmtf_fun_AOADMM.m:625-1075)
    on CP, PARAFAC2-A and par2C modes.  As/rhos/solvers: dicts keyed by
    mode; solvers holds the solvers of the Frobenius modes, prebuilt once
    an outer iteration (_factor_update_case); a mode of another loss takes
    its step from lbfgs_steps.  Returns (state, inner_iters, lbfgsb_totals,
    (pr, dr)): the L-BFGS-B iterations of each non-Frobenius mode summed
    over the steps, and the larger of the last coupling and constraint
    residuals."""
    _check_ctype(ctype)
    upd = make_update_constraint(spec, proxes)
    constrained_modes = tuple(m for m in cmodes if spec.is_constrained(m))
    frob = {m: spec.datasets[spec.which_p(m)].loss == "Frobenius"
            for m in cmodes}
    lb = {m: 0 for m in cmodes if not frob[m]}

    def step(carry, active=None):
        state = carry[0]
        for mm in cmodes:
            if frob[mm]:
                fac = _factor_update_case(
                    spec, state, data, mm, cid, ctype, As[mm], rhos[mm],
                    spec.is_constrained(mm), solvers[mm])
                state = state.replace(fac=tuple_set(state.fac, mm, fac))
            else:
                state, nit = lbfgs_steps[mm](
                    state, data, constrained=spec.is_constrained(mm),
                    coupling_type=ctype, rho=rhos[mm], active=active)
                lb[mm] += nit
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
        return (state, prk, drk, prc, drc), (
            (prk > options.innerRelPrTol_coupl)
            | (prc > options.innerRelPrTol_constr)
            | (drk > options.innerRelDualTol_coupl)
            | (drc > options.innerRelDualTol_constr))

    inf = math.inf
    (state, prk, drk, prc, drc), n = run_inner(
        step, (state, inf, inf, inf, inf), options)
    return state, n, lb, (_larger(prc, prk), _larger(drc, drk))


def _larger(a, b):
    """max of two residuals, each a number or a 0-d tensor."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(a, torch.Tensor):
        return max(a, b)
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))
