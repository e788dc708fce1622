"""The L-BFGS-B factor update of a non-Frobenius (KL / IS / beta) dataset's
mode (counterpart of matlab_code_tpu/models/lbfgs_bridge.py;
compute_gen_f_g + lbfgsb_update, cmtf_fun_AOADMM.m:1365-1418).

value = w sum fh(X, M) plus the ADMM quadratic terms, gradient = w MTTKRP
of the elementwise gradient tensor gh(X, M) plus theirs, derived by hand as
the reference does.  Each evaluation builds the model M = ktensor_full
(torch.einsum), makes the loss pass (ops/losses.loss_fg: kernel D on the
card) and the MTTKRP of gh (ops/tensor.mttkrp: the mttkrp3 kernel for a
3-way dataset on the card).  On a mesh (parallel/), a dataset cut into
blocks makes the loss pass over this rank's block (the model of its rows),
psums sum fh and takes the gh MTTKRP through the sharded MTTKRP
(parallel/shard_mttkrp.block_mttkrp), so every rank's L-BFGS-B sees the
same value and gradient.
"""
from __future__ import annotations

import torch

from matlab_code_tpu_torch.ops import losses
from matlab_code_tpu_torch.ops.lbfgsb import lbfgsb
from matlab_code_tpu_torch.ops.tensor import ktensor_full, mttkrp
from matlab_code_tpu_torch.parallel.sharding import dataset_shard
from matlab_code_tpu_torch.parallel.shard_mttkrp import block_mttkrp
from matlab_code_tpu_torch.problem import ProblemSpec
from matlab_code_tpu_torch.state import tuple_set


def make_lbfgs_step(spec: ProblemSpec, p: int, m: int, options):
    """step(state, data, constrained, coupling_type, rho, active=None) ->
    (state, iterations) updating fac[m] by L-BFGS-B; coupling_type -1 is an
    uncoupled mode.  On fit_multistart's start axis the L-BFGS-B runs its
    lanes form (ops/lbfgsb.py): iterations is each start's count, a
    tensor, and active names the starts that take part (those the inner
    loop still steps, models/admm.run_inner; None: every start)."""
    ds = spec.datasets[p]
    local = ds.modes.index(m)
    lo, hi = losses.loss_bounds(ds.loss)
    lopt = options.lbfgsb
    cid = spec.coupling_id(m)
    ridge = spec.ridge[m] if spec.ridge is not None else 0

    def step(state, data, constrained: bool, coupling_type: int, rho,
             active=None):
        X = data.objects[p]
        sh = dataset_shard(data, p)
        fshape = state.fac[m].shape
        fac0 = state.fac[m]
        if constrained:
            Zc = state.constraint_fac[m]
            muZ = state.constraint_dual_fac[m]
        if coupling_type >= 0:
            Delta = state.coupling_fac[cid - 1]
            muD = state.coupling_dual_fac[m]
            H = data.coupl_trafo[m] if data.coupl_trafo else None
            H2 = data.coupl_trafo2[m] if data.coupl_trafo2 else None

        def vag(xvec):
            x = xvec.reshape(fshape)
            facs = [state.fac[j] if j != m else x for j in ds.modes]
            M = ktensor_full(sh.local_factors(facs)).contiguous()
            fh_sum, Y = losses.loss_fg(ds.loss, X, M, options.eps_log,
                                       ds.loss_param)
            if not sh.cut:
                mk = mttkrp(Y, facs, local)
            else:
                fh_sum, mk = sh.psum(fh_sum), block_mttkrp(sh, Y, facs, local)
            f = ds.weight * fh_sum
            g = ds.weight * mk.reshape(-1)
            if constrained:
                d = xvec - Zc.reshape(-1) + muZ.reshape(-1)
                f = f + rho / 2.0 * torch.sum(d * d)
                g = g + rho * d
            if coupling_type in (0, 3, 4):
                if coupling_type == 0:
                    target = Delta
                elif coupling_type == 3:
                    target = H @ Delta
                else:
                    target = Delta @ H
                d = xvec - target.reshape(-1) + muD.reshape(-1)
                f = f + rho / 2.0 * torch.sum(d * d)
                g = g + rho * d
            elif coupling_type in (1, 5):
                D = H @ x - (Delta if coupling_type == 1 else Delta @ H2) + muD
                f = f + rho / 2.0 * torch.sum(D * D)
                g = g + rho * (H.T @ D).reshape(-1)
            elif coupling_type == 2:
                D = x @ H - Delta + muD
                f = f + rho / 2.0 * torch.sum(D * D)
                g = g + rho * (D @ H.T).reshape(-1)
            if ridge:
                f = f + ridge * torch.sum(xvec * xvec)
                # the reference's gradient is ridge/2 * x here
                # (cmtf_fun_AOADMM.m:1401, half the analytic one), kept
                g = g + ridge / 2.0 * xvec
            if options.bsum:
                d = xvec - fac0.reshape(-1)
                f = f + options.bsum_weight / 2.0 * torch.sum(d * d)
                g = g + options.bsum_weight * d
            return f, g

        res = lbfgsb(vag, fac0.reshape(-1), lo, hi, m=lopt.m,
                     maxiter=lopt.maxIts, pgtol=lopt.pgtol, factr=lopt.factr,
                     max_total_its=lopt.maxTotalIts, active=active)
        state = state.replace(fac=tuple_set(state.fac, m,
                                            res.x.reshape(fshape)))
        return state, res.iterations

    return step
