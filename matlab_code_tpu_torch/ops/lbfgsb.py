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
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from matlab_code_tpu_torch.models.admm import to_host

_LS_MAX_STEPS = 60
_TOL_B = 1e-10        # the active set's distance to a bound


class LbfgsbResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    iterations: int


def lbfgsb(value_and_grad: Callable, x0: torch.Tensor, lower, upper,
           m: int = 5, maxiter: int = 100, pgtol: float = 1e-5,
           factr: float = 1e7, max_total_its: int = 0) -> LbfgsbResult:
    """Minimize fun over the box [lower, upper] from x0 (1-D).
    value_and_grad(x) returns (f, g), a 0-d tensor and x's shape.  lower
    and upper are numbers or tensors broadcast to x0.  max_total_its > 0
    also caps the number of evaluations (iterations plus line-search
    backtracks, from 1), the reference's lbfgsb_options.maxTotalIts."""
    n = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    eps = torch.finfo(dt).eps

    if isinstance(lower, torch.Tensor) or isinstance(upper, torch.Tensor):
        lo, hi = (torch.broadcast_to(torch.as_tensor(b, dtype=dt, device=dev),
                                     (n,)) for b in (lower, upper))
    else:
        lo, hi = float(lower), float(upper)

    def proj(x):
        return torch.clamp(x, lo, hi)

    def pg_norm(x, g):
        return torch.max(torch.abs(x - proj(x - g)))

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
