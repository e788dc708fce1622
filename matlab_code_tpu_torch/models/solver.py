"""The AO-ADMM solver: outer alternating-optimization sweep and fit loop
(counterpart of matlab_code_tpu/models/solver.py; cmtf_fun_AOADMM.m outer
loop :87-476 and cmtf_AOADMM.m).

The JAX package runs the whole fit as one compiled while_loop.  Here the
outer loop is an eager host loop with the same exit rule and the same
per-iteration streams; it reads one combined stop / ill-conditioning flag
from the device per outer iteration, and the inner loops read their
residuals (models/admm.to_host counts every such read).  Per-iteration wall
times are exact, as in the JAX package's fit_stepwise.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from matlab_code_tpu_torch.models.admm import (
    _check_ctype, _chol_rcond_bad, admm_constrained_only, admm_coupled,
    make_spd_solver, to_host)
from matlab_code_tpu_torch.models.objective import func_eval
from matlab_code_tpu_torch.models.updates import cp_mode_precompute, refresh_gram
from matlab_code_tpu_torch.ops import losses
from matlab_code_tpu_torch.ops.linalg import chol_lower, rsolve, sylvester_solver
from matlab_code_tpu_torch.ops.prox import make_prox
from matlab_code_tpu_torch.ops.tensor import gram
from matlab_code_tpu_torch.options import AlgOptions, apply_matmul_precision
from matlab_code_tpu_torch.problem import (
    CP, ProblemData, ProblemSpec, SparseTensor, check_data_input, has_missing)
from matlab_code_tpu_torch.state import SolverState, tuple_set

STREAMS = ("f_tensors", "f_couplings", "f_constraints", "f_PAR2_couplings")


def _check_ported(spec: ProblemSpec) -> None:
    for p, ds in enumerate(spec.datasets):
        if ds.model != CP:
            raise NotImplementedError(
                f"dataset {p} is PARAFAC2: it comes with slice 4 (ROADMAP.md)")
        if ds.loss != "Frobenius":
            raise NotImplementedError(
                f"dataset {p} has loss {ds.loss!r}: non-Frobenius losses come "
                "with slice 5 (ROADMAP.md)")
    for ctype in spec.coupling.coupling_type:
        _check_ctype(ctype)


def build_proxes(spec: ProblemSpec):
    """(prox, reg) of every constrained mode (ops/prox.make_prox)."""
    prox_fns = [None] * spec.nb_modes
    reg_fns = [None] * spec.nb_modes
    for m in range(spec.nb_modes):
        if spec.is_constrained(m):
            prox_fns[m], reg_fns[m] = make_prox(
                spec.constraints[m], spec.mode_sizes[m])
    return tuple(prox_fns), tuple(reg_fns)


def init_cache(spec: ProblemSpec, state: SolverState) -> tuple:
    """Initial Grams of every (CP, Frobenius) mode (cmtf_fun_AOADMM.m:62-81)."""
    _check_ported(spec)
    return tuple(gram(state.fac[m]) for m in range(spec.nb_modes))


def compute_znorm_consts(spec: ProblemSpec, data: ProblemData,
                         options: AlgOptions):
    """Per-dataset data constants (cmtf_AOADMM.m:124-189); sum of squared
    values for a sparse COO dataset."""
    out = []
    for p, ds in enumerate(spec.datasets):
        X = data.objects[p]
        if isinstance(X, SparseTensor):
            out.append(torch.sum(X.values * X.values))
        else:
            out.append(losses.znorm_const(ds.loss, X, options.eps_log,
                                          ds.loss_param, data.miss[p]))
    return tuple(out)


def eligible_pp_datasets(spec: ProblemSpec, data: ProblemData,
                         options: AlgOptions) -> tuple:
    """Datasets the pairwise-perturbation MTTKRP would take when
    options.cp_pairwise_perturbation is set: 3-way CP with Frobenius loss,
    no missing mask, dense 3-way or SparseTensor data (the rule of
    matlab_code_tpu/models/pairwise.py::eligible_pp_datasets, without its
    mesh)."""
    if not options.cp_pairwise_perturbation:
        return ()
    out = []
    for p, ds in enumerate(spec.datasets):
        if ds.model != CP or len(ds.modes) != 3 or ds.loss != "Frobenius":
            continue
        if data.miss and data.miss[p] is not None:
            continue
        X = data.objects[p]
        if isinstance(X, SparseTensor) or getattr(X, "ndim", 0) == 3:
            out.append(p)
    return tuple(out)


def attach_sparse_plans(spec: ProblemSpec, data: ProblemData,
                        options: AlgOptions) -> ProblemData:
    """Attach the CUDA kernel's plans (ops/sparse_cuda.build_plan) to every
    SparseTensor on a CUDA card that has none, whatever
    options.sparse_mttkrp says: on the card every sparse MTTKRP runs the
    kernel.  Set-up work with torch ops on the card, once per sparsity
    pattern.  A dense 3-way dataset on the card that is not contiguous is
    copied once here, since the dense kernel (ops/mttkrp_cuda.mttkrp3)
    never copies X.  Data on the CPU is returned as it is."""
    objs = list(data.objects)
    for p, X in enumerate(objs):
        if isinstance(X, SparseTensor):
            if X.plans is None and X.device.type == "cuda":
                objs[p] = X.with_plans(
                    tuple(spec.mode_sizes[m] for m in spec.datasets[p].modes),
                    spec.datasets[p].rank)
        elif X.dim() == 3 and X.device.type == "cuda" \
                and not X.is_contiguous():
            objs[p] = X.contiguous()
    if all(a is b for a, b in zip(objs, data.objects)):
        return data
    return dataclasses.replace(data, objects=tuple(objs))


def _check_devices(data: ProblemData, state: SolverState) -> None:
    dev = state.fac[0].device
    for p, X in enumerate(data.objects):
        if isinstance(X, SparseTensor) and (X.indices.device != dev
                                            or X.values.device != dev):
            raise ValueError(
                f"dataset {p}: the sparse tensor's indices and values lie on "
                f"{X.indices.device} and {X.values.device}, the factors on "
                f"{dev}")


def make_outer_step(spec: ProblemSpec, options: AlgOptions, proxes, reg_fns):
    """One AO sweep over the coupling ids (cmtf_fun_AOADMM.m:87-407) for CP
    datasets with Frobenius loss.  outer_step(state, data, grams) returns
    (state, grams, cached, inner_its, illc): cached feeds func_eval's
    cached-MTTKRP branch, inner_its maps mode -> inner iterations (int),
    illc is the ill-conditioning flag (0-d bool tensor)."""
    _check_ported(spec)

    def outer_step(state, data, grams):
        inner_its: dict[int, Any] = {}
        cached: dict[int, Any] = {}
        partials: dict[int, Any] = {}
        illc = torch.zeros((), dtype=torch.bool, device=state.fac[0].device)

        def spd_checked(B):
            nonlocal illc
            right, bad = make_spd_solver(B, options, illtol=options.IllCondTol)
            illc = illc | bad
            return right

        for cid in spec.coupling_ids():
            cmodes = spec.coupled_modes_of(cid)
            pres = {}
            for p in sorted({spec.which_p(m) for m in cmodes}):
                ds = spec.datasets[p]
                for m in (m for m in cmodes if spec.which_p(m) == p):
                    pre = cp_mode_precompute(spec, data, state, grams, p, m,
                                             options, partials)
                    cached[p] = (pre.last_mttkrp, pre.last_had,
                                 ds.modes.index(m))
                    if cid != 0:
                        pres[m] = pre
                        continue
                    if not spec.is_constrained(m):
                        if options.IllCondTol > 0:
                            # where MATLAB's nearlySingularMatrix would fire
                            # (cmtf_fun_AOADMM.m:134)
                            illc = illc | _chol_rcond_bad(
                                chol_lower(pre.B), options.IllCondTol)
                        state = state.replace(fac=tuple_set(
                            state.fac, m, rsolve(pre.A, pre.B)))
                        inner_its[m] = 1
                    else:
                        eye = torch.eye(ds.rank, dtype=pre.A.dtype,
                                        device=pre.A.device)
                        solve = spd_checked(pre.B + 0.5 * pre.rho * eye)
                        state, inner_its[m] = admm_constrained_only(
                            spec, state, m, p, pre.A, solve, pre.rho,
                            options, proxes)
                    grams = refresh_gram(spec, state, grams, m)

            if cid != 0:
                ctype = spec.coupling.coupling_type[cid - 1]
                As, rhos, solvers = {}, {}, {}
                for m in cmodes:
                    pre = pres[m]
                    As[m], rhos[m] = pre.A, pre.rho
                    constrained = spec.is_constrained(m)
                    H = data.coupl_trafo[m] if data.coupl_trafo else None
                    eye = torch.eye(spec.mode_rank(m), dtype=pre.A.dtype,
                                    device=pre.A.device)
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
                        B = pre.B + 0.5 * pre.rho * (H @ H.T)
                    else:  # 0, 3, 4
                        B = pre.B + 0.5 * pre.rho * eye
                    if constrained:
                        B = B + 0.5 * pre.rho * eye
                    solvers[m] = spd_checked(B)
                state, nin = admm_coupled(
                    spec, state, data, cmodes, cid, ctype, As, rhos, options,
                    proxes, solvers)
                for m in cmodes:
                    inner_its[m] = nin
                    grams = refresh_gram(spec, state, grams, m)
        return state, grams, cached, inner_its, illc

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


def fit(spec: ProblemSpec, data: ProblemData, state: SolverState,
        options: AlgOptions, validate: bool = True):
    """Run AO-ADMM until the stopping rule holds or MaxOuterIters.  Returns
    (state, FitOutput).  Runs on the device and in the dtype of the data;
    sparse COO data on a CUDA card gets its kernel plans first, and dense
    3-way data on the card is made contiguous once (attach_sparse_plans).
    Raises NotImplementedError where cp_pairwise_perturbation would take a
    dataset (eligible_pp_datasets)."""
    if validate:
        check_data_input(spec, data)
    _check_ported(spec)
    _check_devices(data, state)
    data = attach_sparse_plans(spec, data, options)
    if has_missing(data):
        raise NotImplementedError(
            "missing data (EM imputation) comes with slice 6 (ROADMAP.md)")
    pp = eligible_pp_datasets(spec, data, options)
    if pp:
        raise NotImplementedError(
            f"cp_pairwise_perturbation on datasets {list(pp)}: the "
            "pairwise-perturbation MTTKRP comes with slice 7 (ROADMAP.md)")
    apply_matmul_precision(options)
    znorms = compute_znorm_consts(spec, data, options)
    proxes, reg_fns = build_proxes(spec)
    outer_step = make_outer_step(spec, options, proxes, reg_fns)
    T = options.MaxOuterIters

    grams = init_cache(spec, state)
    f4 = func_eval(spec, data, state, grams, znorms, reg_fns, cached=None,
                   options=options)
    hist = [torch.stack(f4)]
    inner_hist = [np.zeros((spec.nb_modes,), np.int32)]
    times = [0.0]
    if options.Display in ("iter", "final"):
        print(" Iter  f total      f tensors      f couplings    "
              "f constraints    f PAR2 couplings")
        print("------ ------------ -------------  -------------- "
              "---------------- ----------------")

    t0 = time.perf_counter()
    it = 1
    stop = illc = False
    while it <= T and not stop:
        state, grams, cached, inner_its, illc_t = outer_step(state, data, grams)
        f4_new = func_eval(spec, data, state, grams, znorms, reg_fns,
                           cached=cached, options=options)
        f4_vec = torch.stack(f4_new)
        stop_t = stopping(f4_new, f4, options) | ~torch.isfinite(
            torch.sum(f4_vec)) | illc_t
        stop, illc_now = to_host(torch.stack([stop_t, illc_t]))
        illc = illc or illc_now
        hist.append(f4_vec)
        col = np.zeros((spec.nb_modes,), np.int32)
        for m, v in inner_its.items():
            col[m] = v
        inner_hist.append(col)
        times.append(time.perf_counter() - t0)
        if options.Display == "iter" and it % options.DisplayIters == 0:
            v = to_host(f4_vec)
            print(f"{it:6d} {sum(v):12.8f} {v[0]:12.8f} {v[1]:12.8f} "
                  f"{v[2]:12.8f} {v[3]:12.8f}")
        f4 = f4_new
        it += 1
    n_iter = it - 1
    harr = torch.stack(hist).cpu().numpy()
    t_total = time.perf_counter() - t0
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
        f_PAR2_couplings=f4[3], f_rel_missing=float("nan"),
        exit_flag=exit_flag, OuterIterations=n_iter,
        func_val_conv=harr[:, 0], func_coupl_conv=harr[:, 1],
        func_constr_conv=harr[:, 2], func_PAR2_coupl=harr[:, 3],
        func_rel_missing=None, innerIters=np.stack(inner_hist, axis=1),
        time_total=t_total, time_at_it=np.asarray(times))
    if options.Display in ("iter", "final"):
        print(f"{n_iter:6d} {sum(f4):12.8f} {f4[0]:12.8f} {f4[1]:12.8f} "
              f"{f4[2]:12.8f} {f4[3]:12.8f}")
    return state, out


def cmtf_aoadmm(spec: ProblemSpec, data: ProblemData, options: AlgOptions,
                init: SolverState | None = None, init_options=None,
                generator: torch.Generator | None = None, seed: int = 0,
                validate: bool = True):
    """High-level entry point (functions/cmtf_AOADMM.m): initializes if needed
    (init_coupled with `generator`, or one seeded with `seed`), fits, and
    assembles per-dataset factor estimates.  Returns
    (Zhat, state, init_state, out) with Zhat[p] = {'weights', 'factors'}."""
    if init is None:
        if init_options is None:
            raise ValueError("init_options are missing in cmtf_aoadmm")
        from matlab_code_tpu_torch.models.init import init_coupled
        init = init_coupled(spec, data, init_options, generator=generator,
                            seed=seed)
    state, out = fit(spec, data, init, options, validate=validate)
    return assemble_zhat(spec, state), state, init, out


def assemble_zhat(spec: ProblemSpec, state: SolverState):
    """Per-dataset factor estimates as numpy arrays (cmtf_AOADMM.m:197-206);
    ktensor packaging carries implicit unit weights."""
    _check_ported(spec)
    return [{"weights": np.ones(ds.rank),
             "factors": [state.fac[j].detach().cpu().numpy() for j in ds.modes]}
            for ds in spec.datasets]
