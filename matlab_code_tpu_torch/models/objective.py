"""Objective / residual-stream evaluation (CMTF_AOADMM_func_eval,
cmtf_fun_AOADMM.m:1213-1363), counterpart of
matlab_code_tpu/models/objective.py: data terms of CP datasets (any loss)
and PARAFAC2 datasets, masked where entries are missing, the constraints'
regularizer terms (ops/prox.make_prox's reg), ridge, the coupling gaps of
types 0-5 and the PARAFAC2 internal coupling gaps.

Returns the four streams (f_tensors, f_couplings, f_constraints,
f_PAR2_couplings) as 0-d tensors.  A CP data term reads the cached MTTKRP
of the last updated mode (no extra data pass), as does a PARAFAC2 one whose
A mode was updated last; otherwise (iteration 0, or a PARAFAC2 dataset
whose C mode came last) it is evaluated afresh.  A non-Frobenius data term
is w (Znorm_const + sum fh(X, M)): for a dense 3-way dataset that is not
cut over a mesh, of rank 16 at most in float32 and 8 in float64
(losses.takes_fused), one call of losses.loss_fg_mttkrp without its
MTTKRP (on the card the fused kernel D, the model formed in registers),
for any other with the model M materialized.  A Frobenius dataset with a
missing-data mask (True = observed) is evaluated on its observed entries
with the model materialized, before any cached branch
(cmtf_fun_AOADMM.m:1224-1226).

On a mesh (parallel/), a dataset cut into blocks evaluates the branches
that read its data (masked, non-cached, sparse, non-Frobenius) on this
rank's block, with the model of the block's rows, and psums the sums; the
cached branch reads replicated values only.  A PARAFAC2 dataset cut along
K psums each sum over its slices too: the Bk penalty and ridge, the Bk
constraint gap (divided by the full K) and the internal coupling gap; the
tPARAFAC2 penalty, a sum of differences along K, takes the gathered Bk.
"""
from __future__ import annotations

import torch

from matlab_code_tpu_torch.models.admm import _check_ctype, _fro_slices
from matlab_code_tpu_torch.ops import losses
from matlab_code_tpu_torch.ops.tensor import (
    gram, hadamard_grams, khatri_rao, ktensor_full, mttkrp, mttkrp_sparse)
from matlab_code_tpu_torch.parallel.sharding import UNCUT, dataset_shard
from matlab_code_tpu_torch.problem import (
    CP, PAR2, ProblemData, ProblemSpec, SparseTensor)

_fro = torch.linalg.norm


def _mean_nonzero(vals):
    """sum / count of nonzero entries, or the plain sum when all are zero
    (cmtf_fun_AOADMM.m:1327-1329, 1346-1348)."""
    arr = torch.stack(vals)
    nnz = torch.sum(arr != 0)
    return torch.where(nnz > 0, torch.sum(arr) / torch.clamp(nnz, min=1),
                       torch.sum(arr))


def par2_model_slices(spec, state, p, shard=UNCUT):
    """(K, I, Jmax) model slices A diag(c_k) B_k^T; shard: the dataset's
    Shard (cut along K: its slices take the rank's rows of C)."""
    ds = spec.datasets[p]
    A, Bk, C = (state.fac[m] for m in ds.modes)
    C = shard.rows(C)
    return (A[None] * C[:, None, :]) @ Bk.transpose(1, 2)


def cp_model_full(factors) -> torch.Tensor:
    """The dense CP model sum_r a_r o b_r o ... (ktensor_full) as one GEMM,
    the Khatri-Rao product of all but the last factor times the last one's
    transpose, so that it is laid out row-major: the EM-imputed tensor
    built from it reaches the MTTKRP kernel contiguous without a copy."""
    out = khatri_rao(factors[:-1]) @ factors[-1].T
    return out.reshape(tuple(f.shape[0] for f in factors))


def func_eval(spec: ProblemSpec, data: ProblemData, state, grams,
              znorm_consts, reg_fns, cached=None, options=None):
    """The four objective streams.  cached: None (fresh eval) or
    {p: (last_mttkrp, last_had, last_local_mode)} for Frobenius datasets
    (for a PARAFAC2 dataset last_local_mode is 0, 1 or 2: A, Bk, C).
    options: the AlgOptions (eps_log), needed where a loss is not
    Frobenius."""
    like = state.fac[0]
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    fps = []
    for p, ds in enumerate(spec.datasets):
        X = data.objects[p]
        msk = data.miss[p]
        sh = dataset_shard(data, p)
        psum = sh.psum
        # the factors of this rank's block: a dense dataset's cut mode
        # sliced to its rows
        local = (lambda facs: facs) if isinstance(
            X, SparseTensor) else sh.local_factors
        if ds.model == PAR2:
            if msk is not None:
                D = torch.where(msk, X.slices - par2_model_slices(
                    spec, state, p, sh), zero)
                fp = psum(torch.sum(D * D))
            elif cached is not None and p in cached and cached[p][2] == 0:
                last_mk, last_had, _ = cached[p]
                mA = ds.modes[0]
                f2 = torch.sum(last_mk * state.fac[mA])
                f3 = torch.sum(last_had * grams[mA])
                fp = znorm_consts[p] - 2.0 * f2 + f3
            else:
                # padded columns are zero in both and contribute nothing
                D = X.slices - par2_model_slices(spec, state, p, sh)
                fp = psum(torch.sum(D * D))
            fps.append(ds.weight * fp)
            continue
        if ds.loss != "Frobenius":
            facs = [state.fac[j] for j in ds.modes]
            if losses.takes_fused(X, facs[0].shape[-1], sh.cut):
                fh_sum, _ = losses.loss_fg_mttkrp(
                    ds.loss, X, facs, 0, options.eps_log, ds.loss_param,
                    grad=False)
            else:
                # the model materialized, as the reference does; on the
                # card the loss pass is kernel D's old pass
                fh_sum, _ = losses.loss_fg(
                    ds.loss, X, ktensor_full(local(facs)).contiguous(),
                    options.eps_log, ds.loss_param)
            fps.append(ds.weight * (znorm_consts[p] + psum(fh_sum)))
            continue
        if msk is not None:
            M = torch.where(msk, cp_model_full(
                local([state.fac[j] for j in ds.modes])), zero)
            sums = psum(torch.stack([torch.sum(X * M), torch.sum(M * M)]))
            fp = ds.weight * (znorm_consts[p] - 2.0 * sums[0] + sums[1])
        elif cached is not None and p in cached:
            last_mk, last_had, last_m = cached[p]
            mlast = ds.modes[last_m]
            f2 = torch.sum(last_mk * state.fac[mlast])
            f3 = torch.sum(last_had * grams[mlast])
            fp = ds.weight * (znorm_consts[p] - 2.0 * f2 + f3)
        else:
            facs = [state.fac[j] for j in ds.modes]
            if isinstance(X, SparseTensor):
                mk = mttkrp_sparse(X.indices, X.values, facs, 0,
                                   facs[0].shape[0],
                                   plan=None if X.plans is None else X.plans[0])
                f2 = psum(torch.sum(mk * facs[0]))
            else:
                lf = local(facs)
                f2 = psum(torch.sum(mttkrp(X, lf, 0) * lf[0]))
            f3 = torch.sum(hadamard_grams([gram(U) for U in facs]))
            fp = ds.weight * (znorm_consts[p] - 2.0 * f2 + f3)
        fps.append(fp)
    f_tensors = sum(fps)

    # each Bk mode's dataset Shard (cut along K over a mesh, or not)
    bk_sh = {m: dataset_shard(data, spec.which_p(m)) for m in range(
        spec.nb_modes) if spec.mode_role(m) == "par2_B"}
    for m in range(spec.nb_modes):
        rf = reg_fns[m] if reg_fns else None
        if rf is None:
            continue
        sh = bk_sh.get(m, UNCUT)
        if spec.mode_role(m) == "par2_B" and spec.constraints[m].kind != "tPARAFAC2":
            # slice by slice, each on its true J_k rows, so ragged padding
            # never enters the penalty (cmtf_fun_AOADMM.m:1281-1284)
            Bs = state.fac[m]
            sizes = sh.rows(spec.par2_slice_sizes(spec.which_p(m)))
            f_tensors = f_tensors + sh.psum(
                sum(rf(Bs[k, :J]) for k, J in enumerate(sizes)))
        else:
            f_tensors = f_tensors + rf(sh.gather(state.fac[m]))
    if spec.ridge is not None:
        for m in range(spec.nb_modes):
            if spec.ridge[m]:
                sq = bk_sh.get(m, UNCUT).psum(torch.sum(state.fac[m] ** 2))
                f_tensors = f_tensors + spec.ridge[m] * sq

    # coupling gaps (cmtf_fun_AOADMM.m:1302-1329)
    cps = []
    for cid in range(1, spec.coupling.n_couplings + 1):
        ctype = spec.coupling.coupling_type[cid - 1]
        _check_ctype(ctype)
        Delta = state.coupling_fac[cid - 1]
        acc = zero
        for mm in spec.coupled_modes_of(cid):
            fac = state.fac[mm]
            H = data.coupl_trafo[mm] if data.coupl_trafo else None
            if ctype == 0:
                acc = acc + _fro(fac - Delta) / _fro(fac)
            elif ctype in (1, 2):
                t = H @ fac if ctype == 1 else fac @ H
                acc = acc + _fro(t - Delta) / _fro(t)
            elif ctype == 3:
                acc = acc + _fro(fac - H @ Delta) / _fro(fac)
            elif ctype == 4:
                acc = acc + _fro(fac - Delta @ H) / _fro(fac)
            else:
                t = H @ fac
                acc = acc + _fro(t - Delta @ data.coupl_trafo2[mm]) / _fro(t)
        cps.append(acc)
    f_couplings = _mean_nonzero(cps) if cps else zero

    # constraint gaps (cmtf_fun_AOADMM.m:1331-1348)
    fcs = []
    for m in range(spec.nb_modes):
        if not spec.is_constrained(m):
            continue
        fac, Z = state.fac[m], state.constraint_fac[m]
        if spec.mode_role(m) == "par2_B":
            gap = bk_sh[m].psum(
                torch.sum(_fro_slices(fac - Z) / _fro_slices(fac)))
            fcs.append(gap / spec.par2_K(spec.which_p(m)))
        else:
            fcs.append(_fro(fac - Z) / _fro(fac))
    f_constraints = _mean_nonzero(fcs) if fcs else zero

    # PARAFAC2 internal coupling gaps (cmtf_fun_AOADMM.m:1350-1362)
    f_par2 = zero
    par2 = [p for p, ds in enumerate(spec.datasets) if ds.model == PAR2]
    for p in par2:
        facB = state.fac[spec.datasets[p].modes[1]]
        PDB = state.P[p] @ state.DeltaB[p]
        f_par2 = f_par2 + dataset_shard(data, p).psum(
            torch.sum(_fro_slices(facB - PDB) / _fro_slices(facB)))
    if par2:
        # the reference divides by K of the LAST dataset's second mode
        # (its leftover loop variable, cmtf_fun_AOADMM.m:1361); kept
        last_sz = spec.mode_sizes[spec.datasets[-1].modes[1]]
        div = len(last_sz) if isinstance(last_sz, (tuple, list)) else 1
        f_par2 = torch.where(f_par2 > 0, f_par2 / div, f_par2)
    return f_tensors, f_couplings, f_constraints, f_par2
