"""Pairwise-perturbation MTTKRP (Ma and Solomonik, arXiv:2010.12056) for
3-way Frobenius CP datasets, counterpart of
matlab_code_tpu/models/pairwise.py.

Once the factors move slowly, a sweep's MTTKRPs are evaluated to first
order from pairwise partials, the data tensor contracted with one
reference factor,

    T01[r,i,j] = sum_k X[i,j,k] Cr[k,r]      (and T02, T12 alike)

    M0 ~ sum_j T01[r,i,j] B[j,r]  +  sum_k T02[r,i,k] (C - Cr)[k,r]
    M1 ~ sum_i T01[r,i,j] A[i,r]  +  sum_k T12[r,j,k] (C - Cr)[k,r]
    M2 ~ sum_i T02[r,i,k] A[i,r]  +  sum_j T12[r,j,k] (B - Br)[j,r]

with an error of O(||dF||^2), instead of a pass over the data.  The
partials are laid out rank first, (R, a, b) contiguous, where the JAX
package keeps (a, b, R): each contraction is then a batched matrix-vector
product over r that reads a partial in place, where the (a, b, R) layout
made torch.einsum copy it first (20x slower on the sparse workload's
2048 x 2048 x 16 partials, PERF.md).

The gate is the JAX module's: sweeps run exact (the dense kernel
ops/mttkrp_cuda.mttkrp3 or the sparse kernel on the card) until the
sweep-over-sweep factor step falls below options.pp_start_tol; then the
partials are built and the sweeps switch to the approximation; the
partials are rebuilt whenever the perturbation against the reference
factors exceeds options.pp_refresh_tol.  The JAX package decides both
under lax.cond on the device; here the decision is a host branch on one
device read a sweep for every eligible dataset together (models/admm.
to_host), made only once a dataset is seeded, and a rebuild runs only
where that read says so.  Dense partials are torch.einsum contractions,
sparse ones a segment sum by index_add_ over the (a, b) coordinate pair.

pp_sweep_update counts, across fits until reset, the sweeps it gated
(`sweeps`), those that ran the approximation (`active`), the rebuilds
(`rebuilds`) and the first approximated sweep (`first_active`, counted
from 1, None before one).
"""
from __future__ import annotations

import torch

from matlab_code_tpu_torch.models.admm import to_host
from matlab_code_tpu_torch.ops.tensor import mttkrp, mttkrp_sparse
from matlab_code_tpu_torch.options import AlgOptions
from matlab_code_tpu_torch.problem import (
    CP, ProblemData, ProblemSpec, SparseTensor)


def eligible_pp_datasets(spec: ProblemSpec, data: ProblemData,
                         options: AlgOptions) -> tuple:
    """Datasets the approximation applies to when options.
    cp_pairwise_perturbation is set: 3-way CP with Frobenius loss, no
    missing mask (EM imputation changes the data every iteration, which
    would leave the partials stale), dense 3-way or SparseTensor data."""
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


def pp_init(spec: ProblemSpec, data: ProblemData, state,
            pp_datasets: tuple) -> dict:
    """{p: cache} of the eligible datasets: no partials yet, the references
    the current factors, inactive and unseeded (the first sweep only
    records its references).  `active` and `seeded` are host booleans."""
    caches = {}
    for p in pp_datasets:
        ds = spec.datasets[p]
        caches[p] = {"T01": None, "T02": None, "T12": None,
                     "ref0": state.fac[ds.modes[0]],
                     "ref1": state.fac[ds.modes[1]],
                     "ref2": state.fac[ds.modes[2]],
                     "active": False, "seeded": False}
    return caches


def _build_partials(spec, data, p, refs):
    """T01, T02, T12 from the data tensor and the reference factors, one
    exact data pass a partial, each (R, a, b) contiguous."""
    ds = spec.datasets[p]
    X = data.objects[p]
    r0, r1, r2 = refs
    if isinstance(X, SparseTensor):
        idx, val = X.indices, X.values
        I, J, K = (spec.mode_sizes[m] for m in ds.modes)

        def part(a, b, F, c, Da, Db):
            contrib = val[:, None] * F[idx[:, c].long()]
            # the JAX package's segment ids: int64 past 2^31 - 1 segments
            seg = (idx[:, a].long() * Db + idx[:, b] if Da * Db > 2**31 - 1
                   else idx[:, a] * Db + idx[:, b])
            out = torch.zeros((Da * Db, F.shape[1]), dtype=contrib.dtype,
                              device=contrib.device)
            out.index_add_(0, seg, contrib)
            return out.T.reshape(-1, Da, Db).contiguous()

        return (part(0, 1, r2, 2, I, J), part(0, 2, r1, 1, I, K),
                part(1, 2, r0, 0, J, K))
    return (torch.einsum("ijk,kr->rij", X, r2).contiguous(),
            torch.einsum("ijk,jr->rik", X, r1).contiguous(),
            torch.einsum("ijk,ir->rjk", X, r0).contiguous())


def _perturbation(cache, facs):
    """max_i ||F_i - ref_i|| / max(||ref_i||, 1e-300), a 0-d tensor."""
    ds = []
    for i in range(3):
        ref = cache[f"ref{i}"]
        den = torch.clamp(torch.linalg.norm(ref), min=1e-300)
        ds.append(torch.linalg.norm(facs[i] - ref) / den)
    return torch.max(torch.stack(ds))


def pp_sweep_update(spec: ProblemSpec, data: ProblemData, state,
                    caches: dict, options: AlgOptions) -> dict:
    """The sweep-start gate of every eligible dataset (the JAX
    pp_sweep_update, one dataset a call there): measure the factors'
    relative perturbation against the references, then (a) enter the
    approximation or rebuild the partials where the policy says so, or
    (b) keep tracking (an inactive dataset's references follow the
    factors; an active one's pin its partials).  One device read for all
    seeded datasets together; none while no dataset is seeded."""
    facs = {p: tuple(state.fac[m] for m in spec.datasets[p].modes)
            for p in caches}
    seeded = [p for p in caches if caches[p]["seeded"]]
    build = dict.fromkeys(caches, False)
    if seeded:
        flags = torch.stack([
            _perturbation(caches[p], facs[p]) > options.pp_refresh_tol
            if caches[p]["active"] else
            _perturbation(caches[p], facs[p]) < options.pp_start_tol
            for p in seeded])
        build.update(zip(seeded, to_host(flags)))
    out = {}
    for p, cache in caches.items():
        f0, f1, f2 = facs[p]
        if build[p]:
            T01, T02, T12 = _build_partials(spec, data, p, facs[p])
            out[p] = {"T01": T01, "T02": T02, "T12": T12,
                      "ref0": f0, "ref1": f1, "ref2": f2,
                      "active": True, "seeded": True}
            pp_sweep_update.rebuilds += 1
        elif cache["active"]:
            out[p] = dict(cache)
        else:
            out[p] = dict(cache, ref0=f0, ref1=f1, ref2=f2, seeded=True)
    pp_sweep_update.sweeps += 1
    if any(c["active"] for c in out.values()):
        pp_sweep_update.active += 1
        if pp_sweep_update.first_active is None:
            pp_sweep_update.first_active = pp_sweep_update.sweeps
    return out


def reset_counts() -> None:
    """Set pp_sweep_update's counts to zero."""
    pp_sweep_update.sweeps = pp_sweep_update.active = 0
    pp_sweep_update.rebuilds = 0
    pp_sweep_update.first_active = None


reset_counts()


def _exact_mttkrp(spec, X, facs, p, local):
    """The exact dispatch of models/updates.cp_mode_precompute: the dense
    kernel on a 3-way CUDA tensor (einsum on the CPU), the sparse kernel
    through the tensor's plan on the card (its plain version on the
    CPU)."""
    if isinstance(X, SparseTensor):
        return mttkrp_sparse(X.indices, X.values, list(facs), local,
                             spec.mode_sizes[spec.datasets[p].modes[local]],
                             plan=None if X.plans is None else X.plans[local])
    return mttkrp(X, list(facs), local)


def pp_mttkrp(spec, X, facs, p, cache, local):
    """Mode-`local` MTTKRP of dataset p at the current factors `facs`: the
    first-order evaluation from the partials where the dataset is active,
    the exact dispatch otherwise."""
    if not cache["active"]:
        return _exact_mttkrp(spec, X, facs, p, local)
    A, B, C = facs
    if local == 0:
        return (torch.einsum("rij,jr->ir", cache["T01"], B)
                + torch.einsum("rik,kr->ir", cache["T02"], C - cache["ref2"]))
    if local == 1:
        return (torch.einsum("rij,ir->jr", cache["T01"], A)
                + torch.einsum("rjk,kr->jr", cache["T12"], C - cache["ref2"]))
    return (torch.einsum("rik,ir->kr", cache["T02"], A)
            + torch.einsum("rjk,jr->kr", cache["T12"], B - cache["ref1"]))
