"""Shared runner of the example scripts (counterpart of examples/common.py,
the ports of the reference's example_script1..15).  Each script builds its
MATLAB counterpart's configuration (sizes, couplings, constraints, options,
cited per script) on synthetic data with matched statistics, fits it with
the port's cmtf_aoadmm and reports Fit% and FMS against the ground truth.

Every function takes `device` (the card where None) and `dtype` (float64
on the CPU, float32 on the card where None).  run() draws its init with
the port's init_coupled(..., seed=key), a torch generator, so its fit is
held to the scripts' recovery thresholds, not to the JAX package's fit;
run_reference_seeded() replays the reference's own MATLAB-seeded data and
init (utils/matlab_rng.py), which the JAX package's goldens pin.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.models.solver import assemble_zhat, cmtf_aoadmm
from matlab_code_tpu_torch.options import InitOptions
from matlab_code_tpu_torch.ops.tensor import ktensor_full
from matlab_code_tpu_torch.problem import CP, Parafac2Tensor
from matlab_code_tpu_torch.utils.datagen import (
    create_coupled_data, normalize_data, resolve_device)
from matlab_code_tpu_torch.utils.score import fit_score, fms, fms_par2_B


def reference_path(*parts):
    """A file of the MATLAB reference's checkout, whose directory the
    environment variable CMTF_REFERENCE_DIR names; None where it is unset
    or the file is missing (the scripts then take their synthetic
    stand-ins, as the JAX scripts do)."""
    root = os.environ.get("CMTF_REFERENCE_DIR")
    if not root:
        return None
    path = os.path.join(root, *parts)
    return path if os.path.exists(path) else None


def _setup(spec, lambdas, distr, noise, coupl_trafo, coupl_trafo2,
           init_distr, data_rng, bk_style, mode_post, normalize,
           miss_fraction=None, miss_rng=1, delta_override=None,
           device=None, dtype=None):
    """Shared data-generation + init-options prologue of run() and
    run_multistart()."""
    data, Atrue, Delta, _ = create_coupled_data(
        spec, lambdas=lambdas, noise=noise, distr=distr,
        coupl_trafo=coupl_trafo, coupl_trafo2=coupl_trafo2, rng=data_rng,
        bk_style=bk_style, mode_post=mode_post,
        delta_override=delta_override, device=device, dtype=dtype)
    if normalize:
        data, _ = normalize_data(spec, data)
    if miss_fraction:
        data = add_missing(spec, data, miss_fraction, miss_rng)
    init = InitOptions(distr=tuple(init_distr or distr), normalize=True,
                       lambdas_init=tuple(tuple(l) for l in lambdas))
    return data, Atrue, Delta, init


def _plot(out, path, **kw):
    from matlab_code_tpu_torch.utils.plotting import plot_convergence
    plot_convergence(out, path=path, **kw)


def run_reference_seeded(spec, lambdas, distr, opts, noise=0.0,
                         verbose=True, init_distr=None,
                         normalize_columns=False, post_uncoupled=None,
                         coupl_trafo=None, coupl_trafo2=None,
                         bk_style="shift", case1_max_override=True,
                         data_seed="default", init_seed=None,
                         pre_init=None, save_plots=None, device=None,
                         dtype=None, overrides=None):
    """Reference-seeded replay of an example script: data and init are
    drawn on the MATLAB twister stream (utils/matlab_rng.py) in the order
    of create_coupled_data.m (or the specialized generator bk_style /
    case1_max_override / post_uncoupled select) and
    init_coupled_AOADMM_CMTF.m, the data normalized per
    example_script1:86-103, the init per init_options.normalize=1.

    data_seed/init_seed: MATLAB rng() seeds; init_seed=None continues the
    single stream (most scripts), scripts 3 and 13 reseed before the init
    (rng(13)/rng(1), example_script3:112, example_script13:119).
    pre_init(data, rng) -> data: a draw-consuming hook between normalize
    and init (script 12's randperm missing masks, example_script12:
    115-147).  overrides: AlgOptions fields replaced in opts (e.g.
    MaxOuterIters).  Returns the run dict plus the randn rejection-path
    counts summed over both streams."""
    from matlab_code_tpu_torch.utils.matlab_rng import (
        MatlabRNG, matlab_create_coupled_data, matlab_init_coupled)

    device, dtype = resolve_device(device, dtype)
    if overrides:
        opts = dataclasses.replace(opts, **overrides)
    rng = MatlabRNG(data_seed)
    data, Atrue, Delta, rng = matlab_create_coupled_data(
        spec, distr=distr, lambdas=lambdas, noise=noise, rng=rng,
        normalize_columns=normalize_columns, post_uncoupled=post_uncoupled,
        coupl_trafo=coupl_trafo, coupl_trafo2=coupl_trafo2,
        bk_style=bk_style, case1_max_override=case1_max_override,
        device=device, dtype=dtype)
    data, _ = normalize_data(spec, data)
    if pre_init is not None:
        data = pre_init(data, rng)
    irng = rng if init_seed is None else MatlabRNG(init_seed)
    delta_shapes = {cid: tuple(np.asarray(D).shape)
                    for cid, D in Delta.items()}
    state0 = matlab_init_coupled(spec, distr=init_distr or distr,
                                 normalize=True, rng=irng,
                                 coupl_trafo=coupl_trafo,
                                 delta_shapes=delta_shapes or None,
                                 device=device, dtype=dtype)
    zhat, state, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
    report = summarize(spec, data, zhat, Atrue, out, verbose=verbose)
    if save_plots:
        _plot(out, save_plots)
    edge = rng.slowpath_edge + (0 if irng is rng else irng.slowpath_edge)
    tail = rng.slowpath_tail + (0 if irng is rng else irng.slowpath_tail)
    return dict(zhat=zhat, state=state, state0=state0, out=out, data=data,
                Atrue=Atrue, Delta=Delta, report=report, slowpath_edge=edge,
                slowpath_tail=tail)


def run(spec, lambdas, distr, opts, noise=0.0, coupl_trafo=None,
        coupl_trafo2=None, init_distr=None, key=1, data_rng=0,
        bk_style="shift", mode_post=None, delta_shapes=None, normalize=True,
        verbose=True, miss_fraction=None, miss_rng=1, delta_override=None,
        save_plots=None, device=None, dtype=None):
    """Draw the script's data (utils/datagen.create_coupled_data from
    data_rng), init with init_coupled(..., seed=key), fit with cmtf_aoadmm
    and summarize.  save_plots: an optional PNG path for the reference
    scripts' three-panel convergence figure (utils/plotting.py; needs
    matplotlib)."""
    data, Atrue, Delta, init = _setup(
        spec, lambdas, distr, noise, coupl_trafo, coupl_trafo2, init_distr,
        data_rng, bk_style, mode_post, normalize, miss_fraction, miss_rng,
        delta_override, device, dtype)
    state0 = init_coupled(spec, data, init, seed=key,
                          delta_shapes=delta_shapes)
    zhat, state, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
    report = summarize(spec, data, zhat, Atrue, out, verbose=verbose)
    if save_plots:
        _plot(out, save_plots)
    return dict(zhat=zhat, state=state, out=out, data=data, Atrue=Atrue,
                Delta=Delta, report=report)


def run_multistart(spec, lambdas, distr, opts, n_starts, noise=0.0,
                   coupl_trafo=None, coupl_trafo2=None, init_distr=None,
                   data_rng=0, bk_style="shift", mode_post=None,
                   delta_shapes=None, normalize=True, verbose=True,
                   keys=None, delta_override=None, device=None, dtype=None):
    """Best of n_starts random starts on the start axis (fit_multistart;
    the reference's script-15 protocol, example_script15.m:113-135).  With
    keys=range(n_starts) start s is the sequential run(..., key=s) fit."""
    from matlab_code_tpu_torch.models.multistart import fit_multistart
    data, Atrue, Delta, init = _setup(
        spec, lambdas, distr, noise, coupl_trafo, coupl_trafo2, init_distr,
        data_rng, bk_style, mode_post, normalize,
        delta_override=delta_override, device=device, dtype=dtype)
    keys = list(keys) if keys is not None else list(range(n_starts))
    best_state, best_out, finals, stops = fit_multistart(
        spec, data, opts, init, n_starts, delta_shapes=delta_shapes,
        keys=keys)
    if verbose:
        for s in range(n_starts):
            print(f"start {s:2d}: f_tensors={float(finals[s]):.6e} "
                  f"iters={int(stops[s])}")
        print("--- best run ---")
    zhat = assemble_zhat(spec, best_state)
    report = summarize(spec, data, zhat, Atrue, best_out, verbose=verbose)
    return dict(zhat=zhat, state=best_state, out=best_out, data=data,
                Atrue=Atrue, Delta=Delta, report=report,
                finals=np.asarray(finals), stops=np.asarray(stops))


def add_missing(spec, data, fraction, rng=1):
    """Mark a random `fraction` of entries missing (script 12 style): numpy
    default_rng masks drawn on the host as the JAX examples draw them, the
    data and masks on the data's device."""
    rng = np.random.default_rng(rng)
    objects = list(data.objects)
    miss = list(data.miss)
    for p, ds in enumerate(spec.datasets):
        X = objects[p]
        if ds.model == CP:
            mask = torch.tensor(rng.uniform(size=tuple(X.shape)) > fraction,
                                device=X.device)
            objects[p] = torch.where(mask, X, torch.zeros((), dtype=X.dtype,
                                                          device=X.device))
        else:
            mask = torch.tensor(
                rng.uniform(size=tuple(X.slices.shape)) > fraction,
                device=X.device)
            # padded columns are "observed" zeros
            mask = mask | ~X.mask[:, None, :]
            objects[p] = Parafac2Tensor(
                torch.where(mask, X.slices, torch.zeros(
                    (), dtype=X.dtype, device=X.device)), X.mask)
        miss[p] = mask
    return dataclasses.replace(data, objects=tuple(objects), miss=tuple(miss))


def summarize(spec, data, zhat, Atrue, out, verbose=True):
    """Fit% and FMS of every dataset against the ground truth: {p: (fit,
    fms)} for a CP dataset, {p: (fit, fms_A, fms_B, fms_C)} for a PARAFAC2
    one (example_script1:131-152)."""
    lines = [f"exit={out.exit_flag}  iters={out.OuterIterations}  "
             f"f_tensors={out.f_tensors:.3e}  f_coupl={out.f_couplings:.3e}  "
             f"f_constr={out.f_constraints:.3e}  "
             f"f_par2={out.f_PAR2_couplings:.3e}  "
             f"time={out.time_total:.2f}s"]
    stats = {}
    for p, ds in enumerate(spec.datasets):
        if ds.model == CP:
            Xhat = ktensor_full([torch.from_numpy(np.asarray(f))
                                 for f in zhat[p]["factors"]])
            fit = fit_score(data.objects[p], Xhat)
            score = (fms(zhat[p]["factors"], [Atrue[m] for m in ds.modes])
                     if Atrue[ds.modes[0]] is not None else float("nan"))
            stats[p] = (fit, score)
            lines.append(f"  dataset {p} (CP):   Fit={fit:.3f}%  FMS={score:.4f}")
        else:
            sizes = spec.par2_slice_sizes(p)
            sl = data.objects[p].slices.detach().cpu().numpy().astype(float)
            num = den = 0.0
            for k, J in enumerate(sizes):
                Xk = sl[k, :, :J]
                Mk = (zhat[p]["A"] @ np.diag(zhat[p]["C"][k])
                      @ zhat[p]["Bk"][k].T)
                num += np.sum((Xk - Mk) ** 2)
                den += np.sum(Xk ** 2)
            fit = 100.0 * (1.0 - num / den)
            mA, mB, mC = ds.modes
            sA = fms([zhat[p]["A"]], [Atrue[mA]])
            sB = fms_par2_B(zhat[p]["Bk"], Atrue[mB])
            sC = fms([zhat[p]["C"]], [Atrue[mC]])
            stats[p] = (fit, sA, sB, sC)
            lines.append(f"  dataset {p} (PAR2): Fit={fit:.3f}%  "
                         f"FMS_A={sA:.4f} FMS_B={sB:.4f} FMS_C={sC:.4f}")
    text = "\n".join(lines)
    if verbose:
        print(text)
    return stats
