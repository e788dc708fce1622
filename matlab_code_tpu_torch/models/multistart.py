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
    mttkrp3 call in column blocks of 32), and the sequential proxes fold
    the starts into their slice axis (ops/lanes.py);
  * each inner ADMM loop runs while any start still steps, each start
    stopping on its own exit test (models/admm.run_inner), one read a
    step;
  * the outer loop reads each start's stop flag and ill-conditioning flag
    once an iteration.  A start that stopped leaves the batch: its state
    and history stay as they were at its stop (the JAX lane masking), and
    the loop ends once every start has stopped.
`iter_start_PAR2Bkconstraint` switches the sweep at that iteration, as
fit's two phases do, and the best start (the least final f_tensors) comes
back with a full FitOutput.  Starts are drawn with init_coupled, one
seeded generator a start (see fit_multistart for the seeds).

Not on the start axis yet, each raising NotImplementedError: losses other
than Frobenius (their L-BFGS-B line searches read the device once a try,
ops/lbfgsb.py), sparse COO data, the pairwise-perturbation MTTKRP, and
mesh= start sharding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from matlab_code_tpu_torch.models.admm import to_host
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.models.objective import func_eval
from matlab_code_tpu_torch.models.pairwise import eligible_pp_datasets
from matlab_code_tpu_torch.models.solver import (
    STREAMS, FitOutput, _check_devices, _check_ported, _has_bk_constraint,
    attach_sparse_plans, build_proxes, compute_znorm_consts, em_impute,
    init_cache, make_outer_step, stopping)
from matlab_code_tpu_torch.options import (
    AlgOptions, InitOptions, apply_matmul_precision)
from matlab_code_tpu_torch.problem import (
    PAR2, Parafac2Tensor, ProblemData, ProblemSpec, SparseTensor,
    check_data_input, has_missing)
from matlab_code_tpu_torch.state import SolverState, fields_of

_ROADMAP = "ROADMAP.md section 1, item 6 (slice 7)"


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


def _check_reached(spec: ProblemSpec, data: ProblemData, options: AlgOptions
                   ) -> None:
    if spec.has_non_frobenius():
        raise NotImplementedError(
            "fit_multistart: losses other than Frobenius take L-BFGS-B "
            "steps whose line searches read the device once a try; per-start "
            f"line searches are {_ROADMAP}'s next part")
    if any(isinstance(X, SparseTensor) for X in data.objects):
        raise NotImplementedError(
            f"fit_multistart: sparse COO data on the start axis is {_ROADMAP}'s "
            "next part")
    if eligible_pp_datasets(spec, data, options):
        raise NotImplementedError(
            "fit_multistart: the pairwise-perturbation MTTKRP on the start "
            f"axis is {_ROADMAP}'s next part")


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
    start s takes the seed base_key + s.  mesh= (start sharding over
    several cards) raises NotImplementedError, as do the cases the start
    axis does not take yet (models/multistart.py)."""
    if keys is not None:
        keys = [int(k) for k in keys]
        if len(keys) != n_starts:
            raise ValueError(f"got {len(keys)} keys for {n_starts} starts")
    else:
        keys = [int(base_key) + s for s in range(n_starts)]
    if mesh is not None:
        raise NotImplementedError(
            "fit_multistart(mesh=): sharding the start axis over several "
            "cards comes with ROADMAP.md section 1, item 7 (slice 8, "
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
    seam the tests use to start from the JAX package's init states."""
    _check_reached(spec, data, options)
    check_data_input(spec, data)
    _check_ported(spec)
    _check_devices(data, states[0])
    apply_matmul_precision(options)
    data = attach_sparse_plans(spec, data, options)
    S = len(states)
    T = options.MaxOuterIters
    nb = spec.nb_modes
    miss = has_missing(data)
    znorms = compute_znorm_consts(spec, data, options)
    proxes, reg_fns = build_proxes(spec)
    like = states[0].fac[0]
    dev, dt = like.device, like.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    # the per-mode carries of non-Frobenius modes; constant here
    colnorms = (zero,) * nb
    rho_scale = (torch.ones((), dtype=dt, device=dev),) * nb
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

    def start(flat):
        state = SolverState(*flat)
        grams, _ = init_cache(spec, state)
        return grams, torch.stack(func_eval(spec, data, state, grams, znorms,
                                            reg_fns, None, options))

    def make_iterate(bk_active):
        step = make_outer_step(spec, options, proxes, reg_fns, bk_active)

        def one(flat, grams, objs):
            """One outer iteration of one start: the sweep, the EM
            imputation, the objective (fit's order, _FitRun.iterate)."""
            dat = with_objects(objs)
            (state, grams, _, _, cached, inner_its, _, illc, _) = step(
                SolverState(*flat), dat, grams, colnorms, rho_scale)
            frm = nan
            if miss:
                dat, frm = em_impute(spec, dat, state)
                objs = tuple(dense(dat.objects[p]) for p in masked)
            f4 = func_eval(spec, dat, state, grams, znorms, reg_fns,
                           cached=cached, options=options)
            inner = torch.stack([
                v.to(torch.int32) if isinstance(v, torch.Tensor) else
                torch.tensor(v, dtype=torch.int32, device=dev)
                for v in (inner_its.get(m, 0) for m in range(nb))])
            return (fields_of(state), grams, objs, torch.stack(f4 + (frm,)),
                    inner, illc)

        return torch.func.vmap(one, in_dims=(flat_d, gram_d, 0),
                               out_dims=(flat_d, gram_d, 0, 0, 0, 0))

    flat = _stack(states)
    flat_d = _dims(flat)
    gram_d = _dims(init_cache(spec, states[0])[0])
    bk = _has_bk_constraint(spec)
    iterate = {a: make_iterate(a) for a in ((False, True) if bk else (True,))}
    grams, f4 = torch.func.vmap(start, in_dims=(flat_d,),
                                out_dims=(gram_d, 0))(flat)
    objs = tuple(dense(data.objects[p]).expand(S, *dense(data.objects[p]).shape)
                 for p in masked)
    f5 = torch.cat([f4, nan.expand(S, 1)], dim=1)
    hist = [f5]
    inner_h = [torch.zeros((S, nb), dtype=torch.int32, device=dev)]
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
        nflat, ngrams, nobjs, f5n, inner, illc = step(
            _map(take, flat), _map(take, grams), _map(take, objs))
        stop = _stopping_v(f5n[:, :4], take(f5)[:, :4], options)
        if miss:
            stop = stop & (f5n[:, 4] < options.OuterRelTol)
        stop = stop | ~torch.all(torch.isfinite(f5n[:, :4]), dim=1) | illc
        stop_h, illc_h = to_host(torch.stack([stop, illc]))
        if full:
            flat, grams, objs, f5 = nflat, ngrams, nobjs, f5n
            hist.append(f5n)
            inner_h.append(inner)
        else:
            put = lambda a, b: a.index_copy(0, idx, b)
            flat, grams, objs = (_map2(put, a, b) for a, b in
                                 ((flat, nflat), (grams, ngrams),
                                  (objs, nobjs)))
            f5 = put(f5, f5n)
            hist.append(put(torch.zeros_like(f5), f5n))
            inner_h.append(put(torch.zeros_like(inner_h[0]), inner))
        for j, s in enumerate(running):
            stop_iter[s] = it
            illc_l[s] = illc_l[s] or bool(illc_h[j])
            stopped[s] = bool(stop_h[j])
        running = [s for s in running if not stopped[s]]
        it += 1
    harr = torch.stack(hist).cpu().numpy()          # (n + 1, S, 5)
    inner_arr = torch.stack(inner_h).cpu().numpy()  # (n + 1, S, nb)
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
            lbfgsb_iterations=None)

    return Lanes(flat, [output(s) for s in range(S)])
