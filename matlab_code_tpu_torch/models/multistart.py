"""Multi-start fitting: S random starts advance together on one start axis
(counterpart of matlab_code_tpu/models/multistart.py; the reference's
best-of-N protocol, example_script15.m:113-135).

The JAX package stacks the starts' states and vmaps its compiled outer
step over the start axis.  Here the starts' states are stacked the same
way and one outer iteration of one start (the AO sweep and the objective,
as fit runs them) runs under torch.func.vmap over the starts, so each
launch and each device read serves every start:
  * every dense MTTKRP of the S starts is one mttkrp call with the starts'
    columns side by side (ops/tensor.mttkrp_columns; on the card one
    mttkrp3 call in column blocks of 32), and so is every sparse COO
    MTTKRP (one call of the sparse kernel through the plan fit builds at
    rank R); the sequential proxes fold the starts into their slice axis
    (ops/lanes.py);
  * each inner ADMM loop runs while any start still steps, each start
    stopping on its own exit test (models/admm.run_inner), one read a
    step;
  * a mode of a KL, IS or beta dataset takes its factor step by the lanes
    form of L-BFGS-B (ops/lbfgsb.py): each start searches and stops on its
    own, one read a line-search try for every start, and each evaluation's
    loss pass is one launch of kernel D for every start (ops/losses.py);
    each start carries its own column norms and rho scales (the L-BFGS-B
    rho) and its own L-BFGS-B counts;
  * the outer loop reads each start's stop flag and ill-conditioning flag
    once an iteration.  A start that stopped leaves the batch: its state
    and history stay as they were at its stop (the JAX lane masking), and
    the loop ends once every start has stopped.
`iter_start_PAR2Bkconstraint` switches the sweep at that iteration, as
fit's two phases do, and the best start (the least final f_tensors) comes
back with a full FitOutput.  Starts are drawn with init_coupled, one
seeded generator a start (see fit_multistart for the seeds).

A quirk kept from the JAX function: options.cp_pairwise_perturbation is
not read here (matlab_code_tpu/models/multistart.py:133 builds its step
without the pairwise datasets), so every start runs the exact MTTKRPs.
mesh= (start sharding over several cards) raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import NamedTuple

import numpy as np
import torch

from matlab_code_tpu_torch.models.admm import to_host
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.models.objective import func_eval
from matlab_code_tpu_torch.models.solver import (
    STREAMS, FitOutput, _check_devices, _check_ported, _has_bk_constraint,
    attach_sparse_plans, build_proxes, compute_znorm_consts, em_impute,
    init_cache, make_outer_step, stopping)
from matlab_code_tpu_torch.options import (
    AlgOptions, InitOptions, scoped_matmul_precision)
from matlab_code_tpu_torch.problem import (
    PAR2, Parafac2Tensor, ProblemData, ProblemSpec, check_data_input,
    has_missing)
from matlab_code_tpu_torch.state import SolverState, fields_of


def _stopping_v(f4_new, f4_old, options):
    """solver.stopping over the start axis: f4 are (S, 4); returns (S,)."""
    return stopping(f4_new.unbind(1), f4_old.unbind(1), options)


def _stack(states) -> tuple:
    """The starts' states as one flat state whose tensors have the start
    axis first."""
    return tuple(tuple(None if xs[0] is None else torch.stack(xs)
                       for xs in zip(*fields))
                 for fields in zip(*map(fields_of, states)))


def _map(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def _dims(tree):
    """vmap's in_dims / out_dims of a tree: 0 for a tensor, None for None."""
    return _map(lambda x: 0, tree)


def _map2(fn, a, b):
    if isinstance(a, tuple):
        return tuple(_map2(fn, x, y) for x, y in zip(a, b))
    return None if a is None else fn(a, b)


def fit_multistart(spec: ProblemSpec, data: ProblemData, options: AlgOptions,
                   init_options: InitOptions, n_starts: int, base_key=0,
                   delta_shapes=None, keys=None, mesh=None):
    """Best of n_starts random starts, all run together on one start axis.
    Returns (best_state, best_out, finals, stop_iters): the best start's
    state and full FitOutput (the start with the least final f_tensors,
    evaluated at its own stopping iteration), every start's final f_tensors
    (numpy) and stopping iteration.

    Start s is init_coupled(spec, data, init_options, seed=keys[s],
    delta_shapes=delta_shapes), a generator on the data's device seeded
    with the key, as cmtf_aoadmm(..., seed=k) draws it, so keys=[k, ...]
    reproduces the sequential cmtf_aoadmm(..., seed=k) fits.  Without keys,
    start s takes the seed base_key + s, a string base_key first hashed
    to the int of its sha256's first 8 hex digits (the JAX function's
    rule).  Every loss, sparse COO data and EM take the start axis;
    cp_pairwise_perturbation is not read (the JAX function's exact
    MTTKRPs, models/multistart.py).  mesh= (start sharding over several
    cards) raises NotImplementedError."""
    if keys is not None:
        keys = [int(k) for k in keys]
        if len(keys) != n_starts:
            raise ValueError(f"got {len(keys)} keys for {n_starts} starts")
    else:
        if isinstance(base_key, str):
            base_key = int(hashlib.sha256(base_key.encode()).hexdigest()[:8],
                           16)
        keys = [int(base_key) + s for s in range(n_starts)]
    if mesh is not None:
        raise NotImplementedError(
            "fit_multistart(mesh=): sharding the start axis over several "
            "cards comes with ROADMAP.md section 1, item 5 (slice 8, "
            "parallel/)")
    states = [init_coupled(spec, data, init_options, seed=k,
                           delta_shapes=delta_shapes) for k in keys]
    return _fit_lanes(spec, data, states, options).best()


class Lanes(NamedTuple):
    """Every start's result: flat, the final state of all starts (tensors
    with the start axis first; state(s) takes one), and outs, each start's
    FitOutput at its own stopping iteration."""
    flat: tuple
    outs: list

    def state(self, s: int) -> SolverState:
        return SolverState(*_map(lambda x: x[s], self.flat))

    def best(self):
        """(best_state, best_out, finals, stop_iters), fit_multistart's
        return: the best start is the least final f_tensors
        (example_script15.m:126-130)."""
        finals = np.asarray([o.f_tensors for o in self.outs])
        best = int(np.nanargmin(finals))
        return (self.state(best), self.outs[best], finals,
                [o.OuterIterations for o in self.outs])


def _fit_lanes(spec: ProblemSpec, data: ProblemData, states,
               options: AlgOptions) -> Lanes:
    """The starts from given initial states, one a start, on one start
    axis; every start's result (fit_multistart returns its .best()).  The
    seam the tests use to start from the JAX package's init states.  The
    matmul precision holds for the call only (scoped_matmul_precision)."""
    check_data_input(spec, data)
    _check_ported(spec)
    _check_devices(data, states[0])
    with scoped_matmul_precision(options, data.objects[0].device):
        return _run_lanes(spec, data, states, options)


def _run_lanes(spec, data, states, options) -> Lanes:
    data = attach_sparse_plans(spec, data, options)
    S = len(states)
    T = options.MaxOuterIters
    nb = spec.nb_modes
    miss = has_missing(data)
    znorms = compute_znorm_consts(spec, data, options)
    proxes, reg_fns = build_proxes(spec)
    like = states[0].fac[0]
    dev, dt = like.device, like.dtype
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    masked = tuple(p for p in range(len(spec.datasets))
                   if data.miss[p] is not None)

    def with_objects(objs):
        if not masked:
            return data
        objects = list(data.objects)
        for p, X in zip(masked, objs):
            objects[p] = (Parafac2Tensor(X, data.objects[p].mask)
                          if spec.datasets[p].model == PAR2 else X)
        return dataclasses.replace(data, objects=tuple(objects))

    def dense(X):
        return X.slices if isinstance(X, Parafac2Tensor) else X

    def counts(its):
        """A mode -> count dict as an (nb,) int32 tensor, 0 where absent."""
        return torch.stack([
            v.to(torch.int32) if isinstance(v, torch.Tensor) else
            torch.tensor(v, dtype=torch.int32, device=dev)
            for v in (its.get(m, 0) for m in range(nb))])

    def start(flat):
        state = SolverState(*flat)
        grams, colnorms = init_cache(spec, state)
        return grams, colnorms, torch.stack(func_eval(
            spec, data, state, grams, znorms, reg_fns, None, options))

    def make_iterate(bk_active):
        step = make_outer_step(spec, options, proxes, reg_fns, bk_active)

        def one(carry):
            """One outer iteration of one start: the sweep, the EM
            imputation, the objective (fit's order, _FitRun.iterate).
            carry: (state fields, grams, column norms, rho scales, the
            imputed data)."""
            flat, grams, colnorms, rho_scale, objs = carry
            dat = with_objects(objs)
            (state, grams, colnorms, rho_scale, cached, inner_its, lb_its,
             illc, _) = step(SolverState(*flat), dat, grams, colnorms,
                             rho_scale)
            frm = nan
            if miss:
                dat, frm = em_impute(spec, dat, state)
                objs = tuple(dense(dat.objects[p]) for p in masked)
            f4 = func_eval(spec, dat, state, grams, znorms, reg_fns,
                           cached=cached, options=options)
            return ((fields_of(state), grams, colnorms, rho_scale, objs),
                    torch.stack(f4 + (frm,)), counts(inner_its),
                    counts(lb_its), illc)

        return torch.func.vmap(one, in_dims=(carry_d,),
                               out_dims=(carry_d, 0, 0, 0, 0))

    flat = _stack(states)
    grams0, colnorms0 = init_cache(spec, states[0])
    carry_d = (_dims(flat), _dims(grams0), _dims(colnorms0),
               _dims(colnorms0), (0,) * len(masked))
    bk = _has_bk_constraint(spec)
    iterate = {a: make_iterate(a) for a in ((False, True) if bk else (True,))}
    grams, colnorms, f4 = torch.func.vmap(
        start, in_dims=(carry_d[0],), out_dims=carry_d[1:3] + (0,))(flat)
    rho_scale = tuple(torch.ones((S,), dtype=dt, device=dev)
                      for _ in range(nb))
    objs = tuple(dense(data.objects[p]).expand(S, *dense(data.objects[p]).shape)
                 for p in masked)
    carry = (flat, grams, colnorms, rho_scale, objs)
    f5 = torch.cat([f4, nan.expand(S, 1)], dim=1)
    hist = [f5]
    inner_h = [torch.zeros((S, nb), dtype=torch.int32, device=dev)]
    lb_h = [inner_h[0]]
    running = list(range(S))
    stop_iter = [T] * S
    stopped = [False] * S
    illc_l = [False] * S

    t0 = time.perf_counter()
    it = 1
    while it <= T and running:
        full = len(running) == S
        idx = None if full else torch.tensor(running, device=dev)
        take = (lambda x: x) if full else (lambda x: x.index_select(0, idx))
        step = iterate[(not bk) or it >= options.iter_start_PAR2Bkconstraint]
        ncarry, f5n, inner, lb, illc = step(_map(take, carry))
        stop = _stopping_v(f5n[:, :4], take(f5)[:, :4], options)
        if miss:
            stop = stop & (f5n[:, 4] < options.OuterRelTol)
        stop = stop | ~torch.all(torch.isfinite(f5n[:, :4]), dim=1) | illc
        stop_h, illc_h = to_host(torch.stack([stop, illc]))
        if full:
            carry, f5 = ncarry, f5n
            hist.append(f5n)
            inner_h.append(inner)
            lb_h.append(lb)
        else:
            put = lambda a, b: a.index_copy(0, idx, b)
            carry = _map2(put, carry, ncarry)
            f5 = put(f5, f5n)
            hist.append(put(torch.zeros_like(f5), f5n))
            inner_h.append(put(torch.zeros_like(inner_h[0]), inner))
            lb_h.append(put(torch.zeros_like(lb_h[0]), lb))
        for j, s in enumerate(running):
            stop_iter[s] = it
            illc_l[s] = illc_l[s] or bool(illc_h[j])
            stopped[s] = bool(stop_h[j])
        running = [s for s in running if not stopped[s]]
        it += 1
    harr = torch.stack(hist).cpu().numpy()          # (n + 1, S, 5)
    inner_arr = torch.stack(inner_h).cpu().numpy()  # (n + 1, S, nb)
    lb_arr = torch.stack(lb_h).cpu().numpy()
    t_total = time.perf_counter() - t0

    def output(s):
        """Start s's FitOutput, at its own stopping iteration.  The batch
        runs every start together: a start's share of the wall clock is
        the batch's time an iteration, spread evenly
        (matlab_code_tpu/models/multistart.py:274-278)."""
        n_it = stop_iter[s]
        hs = harr[:n_it + 1, s]
        f4 = tuple(float(v) for v in hs[-1, :4])
        if illc_l[s] or not all(np.isfinite(f4)):
            exit_flag = "illconditioned lin system"
        elif not stopped[s]:
            exit_flag = "maxIterations"
        else:
            exit_flag = {n: ("AbsFuncTol" if v < options.AbsFuncTol
                             else "RelFuncTol") for n, v in zip(STREAMS, f4)}
        return FitOutput(
            f_tensors=f4[0], f_couplings=f4[1], f_constraints=f4[2],
            f_PAR2_couplings=f4[3],
            f_rel_missing=float(hs[-1, 4]) if miss else float("nan"),
            exit_flag=exit_flag, OuterIterations=n_it,
            func_val_conv=hs[:, 0], func_coupl_conv=hs[:, 1],
            func_constr_conv=hs[:, 2], func_PAR2_coupl=hs[:, 3],
            func_rel_missing=hs[:, 4] if miss else None,
            innerIters=inner_arr[:n_it + 1, s].T, time_total=t_total,
            time_at_it=np.arange(n_it + 1) * (t_total
                                              / max(max(stop_iter), 1)),
            lbfgsb_iterations=(lb_arr[:n_it + 1, s].T
                               if spec.has_non_frobenius() else None))

    return Lanes(carry[0], [output(s) for s in range(S)])
