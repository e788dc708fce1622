"""The AO-ADMM solver: outer alternating-optimization sweep and fit loop
(counterpart of matlab_code_tpu/models/solver.py; cmtf_fun_AOADMM.m outer
loop :87-476 and cmtf_AOADMM.m).

The JAX package runs the whole fit as one compiled while_loop.  Here the
outer loop is an eager host loop with the same exit rule and the same
per-iteration streams; fit reads one combined stop / ill-conditioning flag
from the device per outer iteration, and the inner loops read their
residuals (models/admm.to_host counts every such read), as does the
L-BFGS-B loop of a non-Frobenius mode (ops/lbfgsb.py: one read a
line-search try) and the pairwise-perturbation gate (models/pairwise.py:
one read a sweep once it is seeded).  Per-iteration wall times are exact.
fit_stepwise runs the same iteration (_FitRun.iterate) and decides the stop
on host floats, as the JAX package's fit_stepwise does.  A delayed PARAFAC2
Bk constraint (options.iter_start_PAR2Bkconstraint, script 9) switches the
sweep at that iteration, as the JAX fit's two phases do.  Missing entries
(ProblemData.miss) are imputed from the model after every sweep
(em_impute, cmtf_fun_AOADMM.m:408-441).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from matlab_code_tpu_torch.models.admm import (
    _check_ctype, _chol_rcond_bad, admm_b_parafac2, admm_constrained_only,
    admm_coupled, make_spd_solver, to_host)
from matlab_code_tpu_torch.models.lbfgs_bridge import make_lbfgs_step
from matlab_code_tpu_torch.models.objective import (
    cp_model_full, func_eval, par2_model_slices)
from matlab_code_tpu_torch.models.pairwise import (
    eligible_pp_datasets, pp_init, pp_mttkrp, pp_sweep_update)
from matlab_code_tpu_torch.models.updates import (
    ModePre, cp_mode_precompute, mode_gram, nonfrob_rho, par2A_precompute,
    par2B_precompute, par2C_precompute, refresh_colnorm_init,
    refresh_colnorm_update, refresh_gram)
from matlab_code_tpu_torch.ops import losses
from matlab_code_tpu_torch.ops.linalg import (
    block_diag, chol_lower, rsolve, solve, solve_spd_left, sylvester_solver)
from matlab_code_tpu_torch.ops.prox import make_prox
from matlab_code_tpu_torch.options import AlgOptions, scoped_matmul_precision
from matlab_code_tpu_torch.problem import (
    CP, PAR2, Parafac2Tensor, ProblemData, ProblemSpec, SparseTensor,
    check_data_input, has_missing)
from matlab_code_tpu_torch.state import SolverState, fields_of, tuple_set

STREAMS = ("f_tensors", "f_couplings", "f_constraints", "f_PAR2_couplings")


def _check_ported(spec: ProblemSpec) -> None:
    for ctype in spec.coupling.coupling_type:
        _check_ctype(ctype)


def build_proxes(spec: ProblemSpec):
    """(prox, reg) of every constrained mode (ops/prox.make_prox).  A
    PARAFAC2 Bk mode's size is its FIRST slice's (the reference's sz{m}(1),
    constraints_to_prox.m:70): the size of a GL smoothness operator."""
    prox_fns = [None] * spec.nb_modes
    reg_fns = [None] * spec.nb_modes
    for m in range(spec.nb_modes):
        if spec.is_constrained(m):
            sz = spec.mode_sizes[m]
            if isinstance(sz, (tuple, list)):
                sz = sz[0]
            prox_fns[m], reg_fns[m] = make_prox(spec.constraints[m], sz)
    return tuple(prox_fns), tuple(reg_fns)


def init_cache(spec: ProblemSpec, state: SolverState) -> tuple:
    """Initial Grams and column norms (cmtf_fun_AOADMM.m:62-81): (grams,
    colnorms).  grams: of every CP and PARAFAC2-A mode of a Frobenius
    dataset, the per-slice Grams (K, R, R) of a Bk mode, None for a par2C
    mode (never read as a Gram) and for a mode of another loss.  colnorms:
    a 0-d tensor a mode, the sum of squared column norms of a mode of a
    non-Frobenius dataset, 0 for every other mode."""
    _check_ported(spec)
    like = state.fac[0]
    grams, colnorms = [], []
    for m in range(spec.nb_modes):
        frob = spec.datasets[spec.which_p(m)].loss == "Frobenius"
        grams.append(mode_gram(spec, state, m)
                     if frob and spec.mode_role(m) != "par2_C" else None)
        colnorms.append(torch.zeros((), dtype=like.dtype, device=like.device)
                        if frob else refresh_colnorm_init(state, m))
    return tuple(grams), tuple(colnorms)


def compute_znorm_consts(spec: ProblemSpec, data: ProblemData,
                         options: AlgOptions):
    """Per-dataset data constants (cmtf_AOADMM.m:124-189); sum of squared
    values for a sparse COO or PARAFAC2 dataset, of the observed entries
    where a PARAFAC2 dataset has a missing-data mask."""
    out = []
    for p, ds in enumerate(spec.datasets):
        X = data.objects[p]
        if ds.model == PAR2:
            Xs = X.slices
            if data.miss[p] is not None:
                Xs = torch.where(data.miss[p], Xs, torch.zeros(
                    (), dtype=Xs.dtype, device=Xs.device))
            out.append(torch.sum(Xs * Xs))
        elif isinstance(X, SparseTensor):
            out.append(torch.sum(X.values * X.values))
        else:
            out.append(losses.znorm_const(ds.loss, X, options.eps_log,
                                          ds.loss_param, data.miss[p]))
    return tuple(out)


def attach_sparse_plans(spec: ProblemSpec, data: ProblemData,
                        options: AlgOptions) -> ProblemData:
    """Attach the CUDA kernel's plans (ops/sparse_cuda.build_plan) to every
    SparseTensor on a CUDA card that has none, whatever
    options.sparse_mttkrp says: on the card every sparse MTTKRP runs the
    kernel.  Set-up work with torch ops on the card, once per sparsity
    pattern.  A dense 3-way dataset on the card that is not contiguous is
    copied once here, since the dense kernel (ops/mttkrp_cuda.mttkrp3)
    never copies X, and so is a dense dataset of a non-Frobenius loss (the
    loss pass, ops/loss_cuda.loss_fg_cuda, takes contiguous X only), and a
    missing-data mask on the card (em_impute's new data take the mask's
    layout).  Data on the CPU is returned as it is."""
    objs = list(data.objects)
    miss = tuple(m.contiguous() if m is not None and m.device.type == "cuda"
                 else m for m in data.miss)
    for p, X in enumerate(objs):
        if isinstance(X, Parafac2Tensor):
            if X.device.type == "cuda" and not X.slices.is_contiguous():
                objs[p] = Parafac2Tensor(X.slices.contiguous(), X.mask)
        elif isinstance(X, SparseTensor):
            if X.plans is None and X.device.type == "cuda":
                objs[p] = X.with_plans(
                    tuple(spec.mode_sizes[m] for m in spec.datasets[p].modes),
                    spec.datasets[p].rank)
        elif X.device.type == "cuda" and not X.is_contiguous() and (
                X.dim() == 3 or spec.datasets[p].loss != "Frobenius"):
            objs[p] = X.contiguous()
    if all(a is b for a, b in zip(objs + list(miss),
                                  data.objects + data.miss)):
        return data
    return dataclasses.replace(data, objects=tuple(objs), miss=miss)


def row_major_state(state: SolverState) -> SolverState:
    """The state with every tensor on the card made row-major, once at a
    fit's entry: the kernels read factors as row-major matrices (the dense
    one, ops/mttkrp_cuda.mttkrp3, never copies an operand), and a caller's
    init may hold others (torch.tensor of a Fortran-ordered numpy array
    keeps its layout).  A state on the CPU is returned as it is."""
    if state.fac[0].device.type != "cuda":
        return state
    return SolverState(*(tuple(None if t is None else t.contiguous()
                               for t in field) for field in fields_of(state)))


def _check_devices(data: ProblemData, state: SolverState) -> None:
    dev = state.fac[0].device
    for p, X in enumerate(data.objects):
        if isinstance(X, SparseTensor) and (X.indices.device != dev
                                            or X.values.device != dev):
            raise ValueError(
                f"dataset {p}: the sparse tensor's indices and values lie on "
                f"{X.indices.device} and {X.values.device}, the factors on "
                f"{dev}")


def _warn_loss_data(spec: ProblemSpec, data: ProblemData) -> None:
    """Data-vs-loss warnings (cmtf_AOADMM.m:162-175): KL expects count data,
    IS positive data.  One device read (to_host) a KL or IS dataset."""
    for p, ds in enumerate(spec.datasets):
        if ds.loss not in ("KL", "IS"):
            continue
        X = data.objects[p]   # dense: check_data_input refuses the rest
        if ds.loss == "KL":
            if to_host(torch.any(X < 0) | torch.any(X != torch.round(X))):
                warnings.warn(f"Using 'KL' but dataset {p} is not count data")
        elif to_host(torch.any(X <= 0)):
            warnings.warn(f"Using 'IS' but dataset {p} is not positive")


def _has_bk_constraint(spec: ProblemSpec) -> bool:
    return any(ds.model == PAR2 and spec.is_constrained(ds.modes[1])
               for ds in spec.datasets)


def make_outer_step(spec: ProblemSpec, options: AlgOptions, proxes, reg_fns,
                    bk_constraint_active: bool = True, pp_datasets=()):
    """One AO sweep over the coupling ids (cmtf_fun_AOADMM.m:87-407) for CP
    and PARAFAC2 datasets.  A mode of a non-Frobenius (KL, IS, beta)
    dataset takes its factor steps by L-BFGS-B (models/lbfgs_bridge.py)
    with rho from the other modes' column norms (updates.nonfrob_rho),
    scaled by rho_scale where options.adaptive_rho_nonfrob holds.
    bk_constraint_active: False before options.iter_start_PAR2Bkconstraint,
    when a PARAFAC2 Bk mode runs unconstrained.  pp_datasets: the datasets
    whose MTTKRPs go through the pairwise-perturbation MTTKRP
    (models/pairwise.py, options.cp_pairwise_perturbation).

    outer_step(state, data, grams, colnorms, rho_scale, pp=None) returns
    (state, grams, colnorms, rho_scale, cached, inner_its, lbfgs_its, illc,
    pp): colnorms and rho_scale hold a 0-d tensor a mode, cached feeds
    func_eval's cached-MTTKRP branch, inner_its and lbfgs_its map mode ->
    inner and L-BFGS-B iterations (ints), illc is the ill-conditioning flag
    (0-d bool tensor), pp the pairwise caches {p: cache} after the sweep's
    gate (pairwise.pp_sweep_update), None without pp_datasets."""
    _check_ported(spec)
    lbfgs_steps = {m: make_lbfgs_step(spec, p, m, options)
                   for p, ds in enumerate(spec.datasets)
                   if ds.loss != "Frobenius" for m in ds.modes}
    adaptive = options.adaptive_rho_nonfrob and spec.has_non_frobenius()

    def outer_step(state, data, grams, colnorms, rho_scale, pp=None):
        impls = {}
        if pp_datasets:
            pp = pp_sweep_update(spec, data, state, pp, options)
            impls = {(p, local): (lambda X, facs, p=p, local=local: pp_mttkrp(
                spec, X, facs, p, pp[p], local))
                for p in pp_datasets for local in range(3)}
        inner_its: dict[int, Any] = {}
        lbfgs_its: dict[int, int] = {}
        cached: dict[int, Any] = {}
        partials: dict = {}
        illc = torch.zeros((), dtype=torch.bool, device=state.fac[0].device)

        def chol_checked(B):
            nonlocal illc
            L = chol_lower(B)
            if options.IllCondTol > 0:
                illc = illc | _chol_rcond_bad(L, options.IllCondTol)
            return L

        def spd_checked(B, lmin=None):
            nonlocal illc
            right, rowleft, bad = make_spd_solver(
                B, options, illtol=options.IllCondTol, lmin=lmin)
            illc = illc | bad
            return right, rowleft

        def screen(B):
            # where MATLAB's nearlySingularMatrix would fire
            # (cmtf_fun_AOADMM.m:134)
            nonlocal illc
            if options.IllCondTol > 0:
                illc = illc | _chol_rcond_bad(chol_lower(B), options.IllCondTol)

        def eye_of(pre):
            return torch.eye(pre.B.shape[-1], dtype=pre.A.dtype,
                             device=pre.A.device)

        def balance_rho(m, res):
            """Residual balancing of mode m's rho factor (Boyd et al. 2011,
            sec. 3.4.1), options.adaptive_rho_nonfrob: x2 where the primal
            residual is 10x the dual, x0.5 the other way, kept in
            [1e-6, 1e6]."""
            nonlocal rho_scale
            if not adaptive:
                return
            kw = dict(dtype=rho_scale[m].dtype, device=rho_scale[m].device)
            pr, dr = (torch.as_tensor(r, **kw) for r in res)
            f = torch.where(pr > 10.0 * dr, torch.tensor(2.0, **kw),
                            torch.where(dr > 10.0 * pr, torch.tensor(0.5, **kw),
                                        torch.tensor(1.0, **kw)))
            rho_scale = tuple_set(rho_scale, m, torch.clamp(
                rho_scale[m] * f, 1e-6, 1e6))

        for cid in spec.coupling_ids():
            cmodes = spec.coupled_modes_of(cid)
            pres = {}
            for p in sorted({spec.which_p(m) for m in cmodes}):
                ds = spec.datasets[p]
                frob = ds.loss == "Frobenius"
                for m in (m for m in cmodes if spec.which_p(m) == p):
                    role = spec.mode_role(m)
                    constrained = spec.is_constrained(m)
                    if role == "par2_B":
                        active = constrained and bk_constraint_active
                        A, Bk, rho = par2B_precompute(
                            spec, data, state, grams, p, m, options,
                            constraint_active=active, partials=partials)
                        right, _ = spd_checked(Bk, lmin=0.5 * rho)
                        cached[p] = (None, None, 1)
                        state, inner_its[m] = admm_b_parafac2(
                            spec, state, m, p, A, right, rho, options, proxes,
                            constraint_active=active,
                            sizes=spec.par2_slice_sizes(p))
                        grams = refresh_gram(spec, state, grams, m)
                        continue
                    if role == "cp" and not frob:
                        rho_nf = nonfrob_rho(colnorms, m)
                        if adaptive:
                            rho_nf = rho_nf * rho_scale[m]
                        pre = ModePre(None, None, rho_nf, None, None)
                    elif role == "cp":
                        pre = cp_mode_precompute(
                            spec, data, state, grams, p, m, options, partials,
                            mttkrp_impl=impls.get((p, ds.modes.index(m))))
                        cached[p] = (pre.last_mttkrp, pre.last_had,
                                     ds.modes.index(m))
                    elif role == "par2_A":
                        pre = par2A_precompute(spec, data, state, grams, p, m,
                                               options)
                        cached[p] = (pre.last_mttkrp, pre.last_had, 0)
                    else:   # par2_C
                        pre = par2C_precompute(spec, data, state, grams, p, m,
                                               options, partials=partials)
                        cached[p] = (None, None, 2)
                    if cid != 0:
                        pres[m] = pre
                    elif not frob:
                        if constrained:
                            state, inner_its[m], lbfgs_its[m], res = \
                                admm_constrained_only(
                                    spec, state, m, p, None, None, pre.rho,
                                    options, proxes, lbfgs_steps[m], data)
                            balance_rho(m, res)
                        else:
                            state, lbfgs_its[m] = lbfgs_steps[m](
                                state, data, False, -1, pre.rho)
                            inner_its[m] = 1
                        colnorms = tuple_set(colnorms, m,
                                             refresh_colnorm_update(state, m))
                    elif not constrained:
                        screen(pre.B)
                        if role == "par2_C":
                            fac = solve(pre.B, pre.A[:, :, None])[:, :, 0]
                        else:
                            fac = rsolve(pre.A, pre.B)
                        state = state.replace(fac=tuple_set(state.fac, m, fac))
                        inner_its[m] = 1
                    else:
                        rho_b = (pre.rho[:, None, None] if role == "par2_C"
                                 else pre.rho)
                        right, rowleft = spd_checked(
                            pre.B + 0.5 * rho_b * eye_of(pre),
                            lmin=0.5 * pre.rho)
                        state, inner_its[m], _, _ = admm_constrained_only(
                            spec, state, m, p, pre.A,
                            rowleft if role == "par2_C" else right, pre.rho,
                            options, proxes)
                    # a PARAFAC2 A mode's Gram is refreshed even where it is
                    # coupled and not yet updated (cmtf_fun_AOADMM.m:190)
                    if role == "par2_A" or (role == "cp" and cid == 0 and frob):
                        grams = refresh_gram(spec, state, grams, m)

            if cid != 0:
                ctype = spec.coupling.coupling_type[cid - 1]
                As, rhos, solvers = {}, {}, {}
                for m in cmodes:
                    pre = pres[m]
                    As[m], rhos[m] = pre.A, pre.rho
                    if spec.datasets[spec.which_p(m)].loss != "Frobenius":
                        continue   # an L-BFGS-B step: no system to build
                    par2C = spec.mode_role(m) == "par2_C"
                    constrained = spec.is_constrained(m)
                    H = data.coupl_trafo[m] if data.coupl_trafo else None
                    eye = eye_of(pre)
                    rho_b = pre.rho[:, None, None] if par2C else pre.rho
                    if ctype in (1, 5) and par2C:
                        # the kron-vectorized system (cmtf_fun_AOADMM.m
                        # :283-297); kron(H, I)^T kron(H, I) = kron(H^T H, I)
                        K, R = pre.A.shape
                        rhoC = torch.mean(pre.rho)
                        B2 = block_diag(pre.B) + 0.5 * rhoC * torch.kron(
                            H.T @ H, eye)
                        if constrained:
                            B2 = B2 + 0.5 * rhoC * torch.eye(
                                K * R, dtype=B2.dtype, device=B2.device)
                        L = chol_checked(B2)
                        solvers[m] = (lambda v, L=L:
                                      solve_spd_left(L, v[:, None])[:, 0])
                        continue
                    if ctype in (1, 5):
                        # the Sylvester pair (cmtf_fun_AOADMM.m:724-728),
                        # decomposed once for the inner loop
                        B2 = 0.5 * pre.rho * (H.T @ H)
                        if constrained:
                            B2 = B2 + 0.5 * pre.rho * torch.eye(
                                H.shape[1], dtype=pre.A.dtype,
                                device=pre.A.device)
                        solvers[m] = sylvester_solver(B2, pre.B)
                        continue
                    if ctype == 2:
                        B = pre.B + 0.5 * rho_b * (H @ H.T)
                        lmin = 0.5 * pre.rho if constrained else None
                    else:  # 0, 3, 4
                        B = pre.B + 0.5 * rho_b * eye
                        lmin = 0.5 * pre.rho
                    if constrained:
                        B = B + 0.5 * rho_b * eye
                    right, rowleft = spd_checked(B, lmin=lmin)
                    solvers[m] = rowleft if par2C else right
                state, nin, lb, res = admm_coupled(
                    spec, state, data, cmodes, cid, ctype, As, rhos, options,
                    proxes, solvers, lbfgs_steps)
                for m in cmodes:
                    inner_its[m] = nin
                    if m in lb:
                        lbfgs_its[m] = lb[m]
                        balance_rho(m, res)
                        colnorms = tuple_set(colnorms, m,
                                             refresh_colnorm_update(state, m))
                    elif spec.mode_role(m) != "par2_C":
                        grams = refresh_gram(spec, state, grams, m)
        return (state, grams, colnorms, rho_scale, cached, inner_its,
                lbfgs_its, illc, pp)

    return outer_step


def stopping(f4, f4_old, options: AlgOptions):
    """evaluate_stopping_conditions.m: every stream below AbsFuncTol or
    changed by less than OuterRelTol (relative).  A 0-d bool tensor."""
    def stream_stop(f, f_old):
        rel = torch.where(f_old > 0, torch.abs(f_old - f) / torch.where(
            f_old > 0, f_old, torch.ones_like(f_old)), torch.abs(f_old - f))
        return (f < options.AbsFuncTol) | (rel < options.OuterRelTol)

    s = stream_stop(f4[0], f4_old[0])
    for i in range(1, 4):
        s = s & stream_stop(f4[i], f4_old[i])
    return s


@dataclass
class FitOutput:
    """The reference's `out` struct (cmtf_fun_AOADMM.m:480-494)."""
    f_tensors: float
    f_couplings: float
    f_constraints: float
    f_PAR2_couplings: float
    f_rel_missing: float
    exit_flag: Any
    OuterIterations: int
    func_val_conv: np.ndarray
    func_coupl_conv: np.ndarray
    func_constr_conv: np.ndarray
    func_PAR2_coupl: np.ndarray
    func_rel_missing: np.ndarray | None
    innerIters: np.ndarray
    time_total: float
    time_at_it: np.ndarray | None = None
    lbfgsb_iterations: np.ndarray | None = None


def em_impute(spec: ProblemSpec, data: ProblemData, state: SolverState):
    """EM imputation (cmtf_fun_AOADMM.m:408-441): every missing entry
    (mask False) of a masked dataset takes the current model's value.
    Returns (data, f_rel_missing): the new ProblemData and the relative
    change of the imputed entries, sqrt(num / max(den, 1e-300)) where den
    > 0, else sqrt(num) (num: the squared change, den: the squared previous
    imputation), a 0-d tensor.  A CP model is built row-major
    (objective.cp_model_full) and a PARAFAC2 one as batched products, so
    the new data tensors are contiguous; a ragged PARAFAC2 dataset's padded
    columns take the model's, which are zero where Bk's padded rows are."""
    like = state.fac[0]
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    num = den = zero
    objects = list(data.objects)
    for p, ds in enumerate(spec.datasets):
        msk = data.miss[p]
        if msk is None:
            continue
        X = objects[p]
        if ds.model == CP:
            M, Xd = cp_model_full([state.fac[j] for j in ds.modes]), X
        else:
            M, Xd = par2_model_slices(spec, state, p), X.slices
        d = torch.where(msk, zero, M - Xd)
        num = num + torch.sum(d * d)
        held = torch.where(msk, zero, Xd)
        den = den + torch.sum(held * held)
        new = torch.where(msk, Xd, M)
        objects[p] = new if ds.model == CP else Parafac2Tensor(new, X.mask)
    frm = torch.where(den > 0, torch.sqrt(num / torch.clamp(den, min=1e-300)),
                      torch.sqrt(num))
    return dataclasses.replace(data, objects=tuple(objects)), frm


class _FitRun:
    """What fit and fit_stepwise share: the set-up, one outer iteration
    (iterate) and the output (output), so the two cannot drift apart."""

    def __init__(self, spec, data, state, options, validate):
        if validate:
            check_data_input(spec, data)
            _warn_loss_data(spec, data)
        _check_ported(spec)
        _check_devices(data, state)
        self.spec, self.options = spec, options
        self.state = state = row_major_state(state)
        self.data = data = attach_sparse_plans(spec, data, options)
        self.miss = has_missing(data)
        self.znorms = compute_znorm_consts(spec, data, options)
        self.proxes, self.reg_fns = build_proxes(spec)
        self.pp_ds = eligible_pp_datasets(spec, data, options)
        self.bk = _has_bk_constraint(spec)
        self.steps = {
            active: make_outer_step(spec, options, self.proxes, self.reg_fns,
                                    active, pp_datasets=self.pp_ds)
            for active in ((False, True) if self.bk else (True,))}
        self.grams, self.colnorms = init_cache(spec, state)
        self.rho_scale = tuple(torch.ones_like(c) for c in self.colnorms)
        self.pp = pp_init(spec, data, state, self.pp_ds) if self.pp_ds else None
        like = state.fac[0]
        self.nan = torch.full((), float("nan"), dtype=like.dtype,
                              device=like.device)
        self.inner_hist = [np.zeros((spec.nb_modes,), np.int32)]
        self.lb_hist = [np.zeros((spec.nb_modes,), np.int32)]

    def evaluate(self, cached=None):
        """The four streams at the current state (func_eval)."""
        return func_eval(self.spec, self.data, self.state, self.grams,
                         self.znorms, self.reg_fns, cached=cached,
                         options=self.options)

    def iterate(self, it: int):
        """Outer iteration `it`: the sweep (the pairwise gate at its start),
        then the EM imputation, then the objective on the imputed data (the
        JAX order, solver.py:496-514).  Returns (f4, frm, illc): the
        streams, the EM change (NaN without missing data) and the sweep's
        ill-conditioning flag, all on the device."""
        step = self.steps[(not self.bk)
                          or it >= self.options.iter_start_PAR2Bkconstraint]
        (self.state, self.grams, self.colnorms, self.rho_scale, cached,
         inner_its, lbfgs_its, illc, self.pp) = step(
            self.state, self.data, self.grams, self.colnorms, self.rho_scale,
            self.pp)
        frm = self.nan
        if self.miss:
            self.data, frm = em_impute(self.spec, self.data, self.state)
        for h, its in ((self.inner_hist, inner_its), (self.lb_hist, lbfgs_its)):
            col = np.zeros((self.spec.nb_modes,), np.int32)
            for m, v in its.items():
                col[m] = v
            h.append(col)
        return self.evaluate(cached), frm, illc

    def output(self, harr, frm, n_iter, stop, illc, times, t_total):
        """The FitOutput of a run: harr the (n_iter + 1, 4) streams, frm the
        (n_iter + 1,) EM changes.  After a pairwise-perturbation fit the
        last entry is the exact objective (the cached one is approximate
        while the approximation runs)."""
        options, T = self.options, self.options.MaxOuterIters
        if self.pp_ds:
            harr[-1] = to_host(torch.stack(self.evaluate()))
        f4 = tuple(float(v) for v in harr[-1])
        if illc:
            exit_flag = "illconditioned lin system"
        elif n_iter >= T and not stop:
            exit_flag = "maxIterations"
        elif not all(np.isfinite(f4)):
            exit_flag = "illconditioned lin system"
        else:
            exit_flag = {n: ("AbsFuncTol" if v < options.AbsFuncTol
                             else "RelFuncTol") for n, v in zip(STREAMS, f4)}
        out = FitOutput(
            f_tensors=f4[0], f_couplings=f4[1], f_constraints=f4[2],
            f_PAR2_couplings=f4[3],
            f_rel_missing=float(frm[-1]) if self.miss else float("nan"),
            exit_flag=exit_flag, OuterIterations=n_iter,
            func_val_conv=harr[:, 0], func_coupl_conv=harr[:, 1],
            func_constr_conv=harr[:, 2], func_PAR2_coupl=harr[:, 3],
            func_rel_missing=np.asarray(frm) if self.miss else None,
            innerIters=np.stack(self.inner_hist, axis=1),
            time_total=t_total, time_at_it=np.asarray(times),
            lbfgsb_iterations=(np.stack(self.lb_hist, axis=1)
                               if self.spec.has_non_frobenius() else None))
        return self.state, out


def fit(spec: ProblemSpec, data: ProblemData, state: SolverState,
        options: AlgOptions, validate: bool = True):
    """Run AO-ADMM until the stopping rule holds or MaxOuterIters.  Returns
    (state, FitOutput).  Runs on the device and in the dtype of the data;
    sparse COO data on a CUDA card gets its kernel plans first, and dense
    3-way data on the card is made contiguous once (attach_sparse_plans).
    Missing entries are imputed after every sweep (em_impute) and the stop
    also needs their relative change below OuterRelTol; eligible datasets
    take the pairwise-perturbation MTTKRP where options.
    cp_pairwise_perturbation is set (models/pairwise.py).  The stop is
    decided on the device and read with the ill-conditioning flag, one read
    an iteration.  With validate, the data are checked (check_data_input)
    and KL or IS data that do not suit the loss are warned of
    (_warn_loss_data)."""
    with scoped_matmul_precision(options, data.objects[0].device):
        run = _FitRun(spec, data, state, options, validate)
        T = options.MaxOuterIters
        f4 = run.evaluate()
        hist = [torch.stack(f4 + (run.nan,))]
        if options.Display in ("iter", "final"):
            print(" Iter  f total      f tensors      f couplings    "
                  "f constraints    f PAR2 couplings")
            print("------ ------------ -------------  -------------- "
                  "---------------- ----------------")

        times = [0.0]
        t0 = time.perf_counter()
        it = 1
        stop = illc = False
        while it <= T and not stop:
            f4_new, frm, illc_t = run.iterate(it)
            f4_vec = torch.stack(f4_new)
            stop_t = stopping(f4_new, f4, options)
            if run.miss:
                stop_t = stop_t & (frm < options.OuterRelTol)
            stop_t = stop_t | ~torch.isfinite(torch.sum(f4_vec)) | illc_t
            stop, illc_now = to_host(torch.stack([stop_t, illc_t]))
            illc = illc or illc_now
            hist.append(torch.cat([f4_vec, frm[None]]))
            times.append(time.perf_counter() - t0)
            if options.Display == "iter" and it % options.DisplayIters == 0:
                v = to_host(f4_vec)
                print(f"{it:6d} {sum(v):12.8f} {v[0]:12.8f} {v[1]:12.8f} "
                      f"{v[2]:12.8f} {v[3]:12.8f}")
            f4 = f4_new
            it += 1
        harr = torch.stack(hist).cpu().numpy()
        state, out = run.output(harr[:, :4], harr[:, 4], it - 1, stop, illc,
                                times, time.perf_counter() - t0)
        if options.Display in ("iter", "final"):
            f4 = (out.f_tensors, out.f_couplings, out.f_constraints,
                  out.f_PAR2_couplings)
            print(f"{out.OuterIterations:6d} {sum(f4):12.8f} {f4[0]:12.8f} "
                  f"{f4[1]:12.8f} {f4[2]:12.8f} {f4[3]:12.8f}")
        return state, out


def fit_stepwise(spec: ProblemSpec, data: ProblemData, state: SolverState,
                 options: AlgOptions, validate: bool = True):
    """fit() with the stop decided on the host (counterpart of the JAX
    package's fit_stepwise): one outer sweep a call of the shared iteration,
    then one device read of its streams, EM change and ill-conditioning
    flag, and the stopping rule on those host floats (the JAX function's
    rule, which in float32 may stop where fit's on-device rule does not).
    Keeps the PARAFAC2 two-phase switch, EM imputation and the pairwise
    perturbation; records true per-iteration wall times."""
    with scoped_matmul_precision(options, data.objects[0].device):
        run = _FitRun(spec, data, state, options, validate)
        f4 = tuple(to_host(torch.stack(run.evaluate())))
        hist, frm_hist, times = [f4], [float("nan")], [0.0]
        t0 = time.perf_counter()
        it = 1
        stop = illc = False
        while it <= options.MaxOuterIters and not stop:
            f4_t, frm_t, illc_t = run.iterate(it)
            vals = to_host(torch.cat([torch.stack(f4_t), frm_t[None],
                                      illc_t[None].to(frm_t.dtype)]))
            f4_new, frm = tuple(vals[:4]), vals[4]
            stop = bool(stopping(*(torch.tensor(v, dtype=torch.float64)
                                   for v in (f4_new, f4)), options))
            if run.miss:
                stop = stop and frm < options.OuterRelTol
            if not all(np.isfinite(f4_new)):
                stop = True
            if vals[5]:
                illc = stop = True
            hist.append(f4_new)
            frm_hist.append(frm)
            times.append(time.perf_counter() - t0)
            f4 = f4_new
            it += 1
        return run.output(np.asarray(hist), np.asarray(frm_hist), it - 1,
                          stop, illc, times, times[-1])


def cmtf_aoadmm(spec: ProblemSpec, data: ProblemData, options: AlgOptions,
                init: SolverState | None = None, init_options=None,
                generator: torch.Generator | None = None, seed: int = 0,
                validate: bool = True):
    """High-level entry point (functions/cmtf_AOADMM.m): initializes if needed
    (init_coupled with `generator`, or one seeded with `seed`), fits, and
    assembles per-dataset factor estimates.  Returns
    (Zhat, state, init_state, out) with Zhat[p] = {'weights', 'factors'}
    for a CP dataset, {'A', 'Bk', 'C'} for a PARAFAC2 one."""
    if init is None:
        if init_options is None:
            raise ValueError("init_options are missing in cmtf_aoadmm")
        from matlab_code_tpu_torch.models.init import init_coupled
        init = init_coupled(spec, data, init_options, generator=generator,
                            seed=seed)
    state, out = fit(spec, data, init, options, validate=validate)
    return assemble_zhat(spec, state), state, init, out


def assemble_zhat(spec: ProblemSpec, state: SolverState):
    """Per-dataset factor estimates as numpy arrays (cmtf_AOADMM.m:197-206):
    {'weights', 'factors'} for a CP dataset (ktensor packaging carries
    implicit unit weights), {'A', 'Bk', 'C'} for a PARAFAC2 dataset, Bk the
    list of each slice's true J_k rows."""
    _check_ported(spec)
    npy = lambda t: t.detach().cpu().numpy()
    zhat = []
    for p, ds in enumerate(spec.datasets):
        if ds.model == CP:
            zhat.append({"weights": np.ones(ds.rank),
                         "factors": [npy(state.fac[j]) for j in ds.modes]})
            continue
        Bs = npy(state.fac[ds.modes[1]])
        zhat.append({"A": npy(state.fac[ds.modes[0]]),
                     "Bk": [Bs[k, :J] for k, J in
                            enumerate(spec.par2_slice_sizes(p))],
                     "C": npy(state.fac[ds.modes[2]])})
    return zhat
