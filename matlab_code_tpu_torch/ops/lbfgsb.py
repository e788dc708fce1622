"""Box-constrained limited-memory BFGS (counterpart of
matlab_code_tpu/ops/lbfgsb.py:32-166), the solver of the KL, IS and beta
factor subproblems (cmtf_fun_AOADMM.m:1409-1418; options at
example_script7:64-69).

The JAX module runs two nested lax.while_loops.  Here the loops run on the
host with the JAX loops' rules, each of which changes the iterates: the
two-loop recursion over a ring of m curvature pairs, the active set with
tol_b = 1e-10 and the steepest-descent safeguard, the first step scaled to
unit length, the projected Armijo backtracking of at most _LS_MAX_STEPS
tries that accepts any strict decrease on its last try, the pair kept
only where s.y > eps |s| |y|, the three stop tests (projected gradient,
relative change of f, a failed search), and the evaluation budget
max_total_its counted from 1.

Every read of a device value goes through models/admm.to_host, so each is
counted: one at the start (the done-at-start test, made only where the
loop may run) and one a line-search try.  A try computes, before its read,
whether it is accepted and, as if it were, the curvature pair's test and
the stop test, so the host reads the three flags together and knows the
ring's count k without another read.  So a call makes 1 + tries reads
(within tries + iterations where it runs an iteration), and tries + 1
evaluations of value_and_grad.

On fit_multistart's start axis (x0 carries it, ops/lanes.py) the lanes
form runs instead, the JAX loops' structure under vmap: the ring is a
fixed (m, n) S / Y / rho stack with each start's own count k, and the
two-loop recursion walks all m slots, masking those a start has not
filled; each start keeps its own step, tries, iterations, evaluations and
stop tests, and a start that stopped searching or iterating keeps its
x, f, g and ring.  The iterations run in step: an iteration's tries go on
while any start still searches, and each try makes one read for every
start (lanes.any_lane: whether any start still searches, and whether any
goes on to another iteration).  So a call makes 1 + the sum, over its
iterations, of the most tries any start took, and S identical starts make
the reads of one.  `iterations` is then each start's count, a tensor.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from matlab_code_tpu_torch.models.admm import to_host
from matlab_code_tpu_torch.ops.lanes import any_lane, keep, on_start_axis

_LS_MAX_STEPS = 60
_TOL_B = 1e-10        # the active set's distance to a bound


class LbfgsbResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    iterations: int | torch.Tensor


def _box(x0: torch.Tensor, lower, upper):
    """(lo, hi, proj, pg_norm) of the box [lower, upper] for iterates like
    x0."""
    n = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    if isinstance(lower, torch.Tensor) or isinstance(upper, torch.Tensor):
        lo, hi = (torch.broadcast_to(torch.as_tensor(b, dtype=dt, device=dev),
                                     (n,)) for b in (lower, upper))
    else:
        lo, hi = float(lower), float(upper)

    def proj(x):
        return torch.clamp(x, lo, hi)

    def pg_norm(x, g):
        return torch.max(torch.abs(x - proj(x - g)))

    return lo, hi, proj, pg_norm


def lbfgsb(value_and_grad: Callable, x0: torch.Tensor, lower, upper,
           m: int = 5, maxiter: int = 100, pgtol: float = 1e-5,
           factr: float = 1e7, max_total_its: int = 0,
           active: torch.Tensor | None = None) -> LbfgsbResult:
    """Minimize fun over the box [lower, upper] from x0 (1-D).
    value_and_grad(x) returns (f, g), a 0-d tensor and x's shape.  lower
    and upper are numbers or tensors broadcast to x0.  max_total_its > 0
    also caps the number of evaluations (iterations plus line-search
    backtracks, from 1), the reference's lbfgsb_options.maxTotalIts.

    Where x0 carries fit_multistart's start axis the lanes form runs
    (_lbfgsb_lanes); active then names the starts that take part (None:
    every start), the others take no iteration."""
    if on_start_axis(x0):
        return _lbfgsb_lanes(value_and_grad, x0, lower, upper, m, maxiter,
                             pgtol, factr, max_total_its, active)
    dt, dev = x0.dtype, x0.device
    eps = torch.finfo(dt).eps
    lo, hi, proj, pg_norm = _box(x0, lower, upper)

    def under_budget(it, tot):
        return it < maxiter and (max_total_its <= 0 or tot < max_total_its)

    x = proj(x0)
    f, g = value_and_grad(x)
    S, Y, rho_h = [None] * m, [None] * m, [None] * m
    k = it = 0
    tot = 1
    done = False
    if under_budget(it, tot):
        done = to_host(pg_norm(x, g) <= pgtol)

    def two_loop(q):
        """The two-loop recursion over the min(k, m) most recent pairs; slot
        (k - 1) % m is the most recent."""
        kk = min(k, m)
        alpha = [None] * m
        for i in range(kk):
            slot = (k - 1 - i) % m
            a = rho_h[slot] * torch.dot(S[slot], q)
            q = q - a * Y[slot]
            alpha[slot] = a
        r = q
        if k > 0:
            last = (k - 1) % m
            sy = torch.dot(S[last], Y[last])
            yy = torch.dot(Y[last], Y[last])
            r = torch.where(yy > 0, sy / yy, torch.ones_like(yy)) * q
        for i in range(kk):
            slot = (k - kk + i) % m
            b = rho_h[slot] * torch.dot(Y[slot], r)
            r = r + (alpha[slot] - b) * S[slot]
        return r

    zero = torch.zeros((), dtype=dt, device=dev)
    while not done and under_budget(it, tot):
        # active set: variables at a bound with the gradient pushing
        # outward are frozen; the quasi-Newton direction lives on the free
        # subspace (the gradient-projection idea of Byrd-Lu-Nocedal)
        active = (((x <= lo + _TOL_B) & (g > 0))
                  | ((x >= hi - _TOL_B) & (g < 0)))
        gf = torch.where(active, zero, g)
        d = torch.where(active, zero, -two_loop(gf))
        # steepest descent on the free subspace where d is no descent
        d = torch.where(torch.dot(gf, d) < 0, d, -gf)
        if k == 0:
            # no curvature yet: a first step of unit length
            alpha = torch.clamp(1.0 / torch.clamp(torch.linalg.norm(d),
                                                  min=1e-30), max=1.0)
        else:
            alpha = torch.ones((), dtype=dt, device=dev)
        ok = good_pair = stop = False
        ls_it = 0
        while not ok and ls_it < _LS_MAX_STEPS:
            x_try = proj(x + alpha * d)
            f_try, g_try = value_and_grad(x_try)
            ok_t = f_try <= f + 1e-4 * torch.dot(g, x_try - x)
            if ls_it == _LS_MAX_STEPS - 1:
                # accept any strict decrease on the last backtrack
                ok_t = ok_t | (f_try < f)
            s, yv = x_try - x, g_try - g
            sy = torch.dot(s, yv)
            good_t = sy > eps * torch.linalg.norm(s) * torch.linalg.norm(yv)
            stop_t = (pg_norm(x_try, g_try) <= pgtol) | (
                (f - f_try) <= factr * eps * torch.clamp(
                    torch.maximum(torch.abs(f), torch.abs(f_try)), min=1.0))
            ok, good_pair, stop = to_host(torch.stack([ok_t, good_t, stop_t]))
            ls_it += 1
            if not ok:
                alpha = alpha * 0.5
        it += 1
        tot += ls_it
        if not ok:
            # a failed search keeps x and ends the loop
            break
        x, f, g = x_try, f_try, g_try
        if good_pair:
            slot = k % m
            S[slot], Y[slot] = s, yv
            rho_h[slot] = 1.0 / torch.where(sy == 0, torch.ones_like(sy), sy)
            k += 1
        done = stop
    return LbfgsbResult(x=x, f=f, iterations=it)


def _lbfgsb_lanes(value_and_grad, x0, lower, upper, m, maxiter, pgtol, factr,
                  max_total_its, active):
    """lbfgsb on the start axis: the host loop's rules, each start with its
    own state (the module docstring)."""
    n = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    eps = torch.finfo(dt).eps
    lo, hi, proj, pg_norm = _box(x0, lower, upper)
    i32 = dict(dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    slots = torch.arange(m, device=dev)

    def budget(it, tot):
        ok = it < maxiter
        return ok & (tot < max_total_its) if max_total_its > 0 else ok

    x = proj(x0)
    f, g = value_and_grad(x)
    it = torch.zeros((), **i32)
    if maxiter < 1 or max_total_its == 1:
        return LbfgsbResult(x=x, f=f, iterations=it)
    Sr = Yr = torch.zeros((m, n), dtype=dt, device=dev)
    rho_r = torch.zeros((m,), dtype=dt, device=dev)
    k = torch.zeros((), **i32)
    tot = torch.ones((), **i32)
    done = pg_norm(x, g) <= pgtol
    if active is not None:
        done = done | ~active
    go = ~done
    if not to_host(any_lane(go)):
        return LbfgsbResult(x=x, f=f, iterations=it)

    def at(ring, slot):
        return ring.index_select(0, slot.reshape(1))[0]

    def two_loop(q):
        """The two-loop recursion over all m slots, a slot a start has not
        filled (i >= min(k, m)) adding nothing; slot (k - 1) % m is the most
        recent."""
        kk = torch.clamp(k, max=m)
        alpha = torch.zeros((m,), dtype=dt, device=dev)
        for i in range(m):
            slot = (k - 1 - i) % m
            a = torch.where(
                i < kk, at(rho_r, slot) * torch.dot(at(Sr, slot), q), zero)
            q = q - a * at(Yr, slot)
            alpha = torch.where(slots == slot, a, alpha)
        last = (k - 1) % m
        s_l, y_l = at(Sr, last), at(Yr, last)
        yy = torch.dot(y_l, y_l)
        r = torch.where((k > 0) & (yy > 0), torch.dot(s_l, y_l) / yy, one) * q
        for i in range(m):
            slot = (k - kk + i) % m
            b = at(rho_r, slot) * torch.dot(at(Yr, slot), r)
            r = r + torch.where(i < kk, at(alpha, slot) - b,
                                zero) * at(Sr, slot)
        return r

    while True:
        # a new iteration of the starts in go (the host loop's body)
        bound = (((x <= lo + _TOL_B) & (g > 0))
                 | ((x >= hi - _TOL_B) & (g < 0)))
        gf = torch.where(bound, zero, g)
        d = torch.where(bound, zero, -two_loop(gf))
        d = torch.where(torch.dot(gf, d) < 0, d, -gf)
        alpha = torch.where(k == 0, torch.clamp(1.0 / torch.clamp(
            torch.linalg.norm(d), min=1e-30), max=1.0), one)
        searching = go
        ls_it = torch.zeros((), **i32)
        while True:
            x_try = proj(x + alpha * d)
            f_try, g_try = value_and_grad(x_try)
            ok = (f_try <= f + 1e-4 * torch.dot(g, x_try - x)) | (
                (ls_it == _LS_MAX_STEPS - 1) & (f_try < f))
            s, yv = x_try - x, g_try - g
            sy = torch.dot(s, yv)
            good = sy > eps * torch.linalg.norm(s) * torch.linalg.norm(yv)
            stop = (pg_norm(x_try, g_try) <= pgtol) | (
                (f - f_try) <= factr * eps * torch.clamp(
                    torch.maximum(torch.abs(f), torch.abs(f_try)), min=1.0))
            ls_it = ls_it + searching.to(torch.int32)
            acc = searching & ok
            end = acc | (searching & (ls_it >= _LS_MAX_STEPS))
            it = it + end.to(torch.int32)
            tot = tot + torch.where(end, ls_it, 0)
            x, f, g = keep(acc, (x_try, f_try, g_try), (x, f, g))
            # the curvature pair into slot k % m where it is kept
            put = (slots == k % m) & acc & good
            Sr = torch.where(put[:, None], s, Sr)
            Yr = torch.where(put[:, None], yv, Yr)
            rho_r = torch.where(put, 1.0 / torch.where(
                sy == 0, torch.ones_like(sy), sy), rho_r)
            k = k + (acc & good).to(torch.int32)
            # a failed search keeps x and ends the start's loop
            done = done | (end & ~(acc & ~stop))
            alpha = torch.where(searching & ~ok, alpha * 0.5, alpha)
            searching = searching & ~end
            go = ~searching & ~done & budget(it, tot)
            more, again = to_host(any_lane(torch.stack([searching, go])))
            if not more:
                break
        if not again:
            break
    return LbfgsbResult(x=x, f=f, iterations=it)
