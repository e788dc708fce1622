"""Synthetic coupled-data factories (counterpart of
matlab_code_tpu/utils/datagen.py: functions/create_coupled_data.m and the
six specialized generators in functions_for_example_scripts/).

Every draw is made on the host in numpy from np.random.default_rng, in the
JAX package's order, so a seed gives the JAX generator's arrays bit for bit:
coupling-aware ground-truth factors for coupling types 0-5, PARAFAC2 Bk
families (shift / orthonormal / smooth-polynomial / unimodal-Gaussian /
temporal), CP assembly with Gaussian / Poisson / Gamma observation noise.
Only the last step moves the data to torch tensors on `device` (the card
unless the caller asks for the CPU) in `dtype` (float64 on the CPU, float32
on the card, the JAX examples' choice: examples/common.py turns on x64 for
the CPU backend only).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from matlab_code_tpu_torch.problem import (
    CP, PAR2, Parafac2Tensor, ProblemData, ProblemSpec)


def resolve_device(device=None, dtype=None):
    """(torch.device, dtype) of a data generator: the card where device is
    None; float64 on the CPU and float32 on the card where dtype is None."""
    device = torch.device("cuda" if device is None else device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    return device, dtype


def to_problem_data(spec: ProblemSpec, X, coupl_trafo, coupl_trafo2,
                    device, dtype) -> ProblemData:
    """ProblemData on `device` in `dtype` from host arrays: X[p] a CP array or
    a PARAFAC2 dataset's list of slices (I, J_k), padded to (K, I, Jmax)
    with its column mask as the JAX package's Parafac2Tensor.from_list pads
    it; H matrices (or None) per mode."""
    npdt = torch.empty((), dtype=dtype).numpy().dtype

    def t(a):      # row-major, as jnp arrays are (MATLAB draws fill by column)
        return torch.tensor(np.ascontiguousarray(a, dtype=npdt), device=device)

    objects = []
    for p, ds in enumerate(spec.datasets):
        if ds.model == PAR2:
            slices = X[p]
            Jmax = max(s.shape[1] for s in slices)
            out = np.zeros((len(slices), slices[0].shape[0], Jmax), npdt)
            mask = np.zeros((len(slices), Jmax), bool)
            for k, s in enumerate(slices):
                out[k, :, :s.shape[1]] = s
                mask[k, :s.shape[1]] = True
            objects.append(Parafac2Tensor(
                torch.tensor(out, device=device),
                torch.tensor(mask, device=device)))
        else:
            objects.append(t(X[p]))
    return ProblemData(
        objects=tuple(objects),
        coupl_trafo=tuple(None if H is None else t(H) for H in coupl_trafo),
        coupl_trafo2=tuple(None if H is None else t(H) for H in coupl_trafo2))


def _sampler(d, rng):
    if callable(d):
        return lambda *shape: d(rng, shape)
    if d == "rand":
        return lambda *shape: rng.uniform(size=shape)
    if d == "randn":
        return lambda *shape: rng.standard_normal(shape)
    if d == "rand+0.1":
        return lambda *shape: rng.uniform(size=shape) + 0.1
    if isinstance(d, tuple) and d[0] == "gamma":
        shape_p, scale_p = d[1], d[2]
        return lambda *shape: rng.gamma(shape_p, scale_p, size=shape)
    raise ValueError(f"Unknown distr {d!r}")


def _normalize(A):
    return A / np.linalg.norm(A, axis=0, keepdims=True)


def _shift_bks(AA, sizes):
    """SHIFT PARAFAC: B_k = circshift(B_1, k-1) (create_coupled_data.m:64-72)."""
    return [np.roll(AA, k, axis=0) for k in range(len(sizes))]


def _orth_bks(sizes, R, samp):
    """Orthonormal ragged Bk (create_irregularPARAFAC2_coupled_data.m:63-70)."""
    out = []
    for J in sizes:
        Q, _ = np.linalg.qr(samp(J, R))
        out.append(Q[:, :R])
    return out


def _smooth_bks(sizes, R, rng, normalize_columns=False):
    """Cubic-polynomial-basis smooth Bk (create_coupled_data_smoothBks.m:66-84,
    per-column normalization when requested :77-81); ragged sizes sample the
    same cubic subspace on each slice's own J_k grid."""
    if min(sizes) < 4:
        raise ValueError(
            f"bk_style='smooth' needs every PARAFAC2 slice size >= 4 (the "
            f"cubic basis [1,x,x^2,x^3] has 4 columns, "
            f"create_coupled_data_smoothBks.m:70-72); got sizes "
            f"{tuple(sizes)}")

    def basis(J):
        x = np.linspace(-1, 1, J)
        M = np.stack([np.ones(J), x, x ** 2, x ** 3], axis=1)
        Morth, _, _ = np.linalg.svd(M, full_matrices=False)
        return Morth
    cache = {J: basis(J) for J in dict.fromkeys(sizes)}
    B = rng.standard_normal((R, R))
    out = []
    for J in sizes:
        Pk, _ = np.linalg.qr(rng.standard_normal((4, R)))
        Bk = cache[J] @ (Pk[:, :R] @ B)
        out.append(_normalize(Bk) if normalize_columns else Bk)
    return out


def _temporal_bks(sizes, R, rng, drift=0.05):
    """Temporally smooth Bk: a slow random walk across k (a synthetic
    stand-in for example_script11's tPARAFAC2 fixture data)."""
    J = sizes[0]
    B = rng.uniform(size=(J, R))
    out = [B]
    for _ in sizes[1:]:
        B = B + drift * rng.standard_normal((J, R))
        out.append(B)
    return out


def _unimodal_bks(sizes, R, rng):
    """Shifted Gaussian-bump Bk (create_coupled_data_unimodalBks.m:66-82),
    each slice's bumps on its own J_k grid."""
    def bumps(J, shift):
        x = np.linspace(-10, 10, J)
        AA = np.zeros((J, R))
        for r in range(R):
            mu = -7 + r * 7
            AA[:, r] = np.exp(-0.5 * ((x - mu) / 0.8) ** 2) / (
                0.8 * np.sqrt(2 * np.pi))
        return np.roll(AA, shift, axis=0)
    return [bumps(J, k) for k, J in enumerate(sizes)]


def create_coupled_data(spec: ProblemSpec, lambdas, noise, distr,
                        coupl_trafo=None, coupl_trafo2=None,
                        normalize_columns=False, rng=0,
                        bk_style="shift", mode_post=None,
                        delta_override=None, device=None, dtype=None):
    """Generate coupled ground-truth factors + noisy data.

    lambdas[p]: component norms per dataset; noise: scalar or per-dataset;
    distr[m]: 'rand' | 'randn' | 'rand+0.1' | ('gamma', shape, scale) |
    callable(rng, shape); bk_style: 'shift' | 'orth' | 'smooth' |
    'unimodal' | 'temporal'; mode_post: optional {m: callable(A)->A}
    post-hooks (e.g. simplex normalization of one mode,
    example5simplex:73-77).  delta_override: optional {cid: array} fixing a
    coupling's ground-truth consensus instead of sampling it (types 0-4;
    e.g. script 15's TrueDesign.mat design, example_script15_realdata.m:
    43-51,138).  rng: an int seed or a numpy Generator.  device, dtype: of
    the returned data (resolve_device).

    Returns (data: ProblemData, Atrue: list per mode (numpy), Delta: dict
    per cid, sigma: list per dataset).
    """
    device, dtype = resolve_device(device, dtype)
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    nb = spec.nb_modes
    P = len(spec.datasets)
    noise = [noise] * P if np.isscalar(noise) else list(noise)
    coupl_trafo = coupl_trafo or [None] * nb
    coupl_trafo2 = coupl_trafo2 or [None] * nb
    A = [None] * nb
    Delta = {}

    def samp(m):
        return _sampler(distr[m], rng)

    # uncoupled modes (create_coupled_data.m:55-75)
    for p, ds in enumerate(spec.datasets):
        R = len(lambdas[p])
        for n in ds.modes:
            if spec.coupling_id(n) != 0:
                continue
            if ds.model == PAR2 and ds.modes.index(n) == 1:
                sizes = spec.par2_slice_sizes(p)
                if bk_style in ("shift", "temporal") and len(set(sizes)) > 1:
                    # circshift / random-walk Bk need one common J grid
                    # (create_coupled_data.m:64-72)
                    raise ValueError(
                        f"bk_style='{bk_style}' assumes equal PARAFAC2 slice "
                        f"sizes, got ragged {tuple(sizes)}; use bk_style="
                        "'orth', 'smooth' or 'unimodal' for ragged slices")
                if bk_style == "shift":
                    AA = samp(n)(sizes[0], R)
                    if normalize_columns:
                        AA = _normalize(AA)
                    A[n] = _shift_bks(AA, sizes)
                elif bk_style == "orth":
                    A[n] = _orth_bks(sizes, R, samp(n))
                elif bk_style == "smooth":
                    A[n] = _smooth_bks(sizes, R, rng, normalize_columns)
                elif bk_style == "unimodal":
                    A[n] = _unimodal_bks(sizes, R, rng)
                elif bk_style == "temporal":
                    A[n] = _temporal_bks(sizes, R, rng)
                else:
                    raise ValueError(bk_style)
            else:
                An = samp(n)(spec.mode_sizes[n], R)
                if normalize_columns:
                    An = _normalize(An)
                A[n] = An
            if mode_post and n in mode_post:
                A[n] = mode_post[n](A[n])

    # coupled modes (create_coupled_data.m:78-150, example13:137-151 for type 5)
    delta_override = delta_override or {}

    def ovr(cid, shape):
        D = np.asarray(delta_override[cid], np.float64)
        if D.shape != shape:
            raise ValueError(
                f"delta_override[{cid}] has shape {D.shape}, the coupling "
                f"needs {shape}")
        return D

    for cid in range(1, spec.coupling.n_couplings + 1):
        ctype = spec.coupling.coupling_type[cid - 1]
        cmodes = list(spec.coupled_modes_of(cid))
        mode1 = cmodes[0]
        p1 = spec.which_p(mode1)
        R1 = len(lambdas[p1])
        if ctype == 5 and cid in delta_override:
            raise ValueError("delta_override is not supported for type-5 "
                             "couplings (the truth is derived from a "
                             "sampled factor there)")
        if ctype == 0:
            if cid in delta_override:
                A[mode1] = ovr(cid, (spec.mode_sizes[mode1], R1))
            else:
                A[mode1] = samp(mode1)(spec.mode_sizes[mode1], R1)
                if normalize_columns:
                    A[mode1] = _normalize(A[mode1])
            for j in cmodes[1:]:
                A[j] = A[mode1].copy()
        elif ctype == 1:
            if cid in delta_override:
                Delta[cid] = ovr(cid, (coupl_trafo[mode1].shape[0], R1))
                for j in cmodes:
                    A[j] = np.linalg.pinv(coupl_trafo[j]) @ Delta[cid]
            else:
                big = max(cmodes, key=lambda m: spec.mode_sizes[m])
                A[big] = samp(big)(spec.mode_sizes[big], R1)
                if normalize_columns:
                    A[big] = _normalize(A[big])
                Delta[cid] = coupl_trafo[big] @ A[big]
                for j in cmodes:
                    if j != big:
                        A[j] = np.linalg.pinv(coupl_trafo[j]) @ Delta[cid]
        elif ctype == 2:
            if cid in delta_override:
                D = ovr(cid, (spec.mode_sizes[mode1],
                              coupl_trafo[mode1].shape[1]))
            else:
                D = samp(mode1)(spec.mode_sizes[mode1],
                                coupl_trafo[mode1].shape[1])
                if normalize_columns:
                    D = _normalize(D)
            Delta[cid] = D
            for j in cmodes:
                Aj = np.linalg.lstsq(coupl_trafo[j].T, D.T, rcond=None)[0].T
                zero = np.where(np.abs(Aj).sum(axis=0) == 0)[0]
                if len(zero):
                    Aj[:, zero] = samp(j)(spec.mode_sizes[j], len(zero))
                    if normalize_columns:
                        Aj[:, zero] = _normalize(Aj[:, zero])
                A[j] = Aj
        elif ctype == 3:
            if cid in delta_override:
                D = ovr(cid, (coupl_trafo[mode1].shape[1], R1))
            else:
                D = samp(mode1)(coupl_trafo[mode1].shape[1], R1)
                if normalize_columns:
                    D = _normalize(D)
            Delta[cid] = D
            for j in cmodes:
                A[j] = coupl_trafo[j] @ D
        elif ctype == 4:
            if cid in delta_override:
                D = ovr(cid, (spec.mode_sizes[mode1],
                              coupl_trafo[mode1].shape[0]))
            else:
                D = samp(mode1)(spec.mode_sizes[mode1],
                                coupl_trafo[mode1].shape[0])
                if normalize_columns:
                    D = _normalize(D)
            Delta[cid] = D
            for j in cmodes:
                A[j] = D @ coupl_trafo[j]
        else:  # type 5, create_coupled_data_example13.m:137-151
            big = max(cmodes, key=lambda m: spec.mode_sizes[m])
            Abig = samp(big)(spec.mode_sizes[big], R1)
            if normalize_columns:
                Abig = _normalize(Abig)
            Delta[cid] = coupl_trafo[big] @ Abig
            for j in cmodes:
                if j != big:
                    A[j] = np.linalg.pinv(coupl_trafo[j]) @ Delta[cid]
            A[big] = Abig @ coupl_trafo2[big]

    # data assembly (create_coupled_data.m:152-183)
    X = [None] * P
    sigma = [None] * P
    for p, ds in enumerate(spec.datasets):
        lam = np.asarray(lambdas[p], dtype=float)
        if ds.model == CP:
            facs = [A[n] for n in ds.modes]
            subs = "abcdef"[: len(facs)]
            eq = ",".join(f"{s}r" for s in subs) + ",r->" + subs
            M = np.einsum(eq, *facs, lam)
            if ds.loss == "Frobenius":
                N = rng.standard_normal(M.shape)
                s = noise[p] * np.linalg.norm(M) / np.linalg.norm(N)
                X[p] = M + s * N
                sigma[p] = s
            elif ds.loss == "KL":
                X[p] = rng.poisson(np.maximum(M, 0)).astype(float)
                sigma[p] = 0.0
            elif ds.loss in ("IS", "beta"):
                # Gamma observation noise with shape loss_param
                # (create_coupled_data.m:165-166); 'beta' takes the same
                # positive multiplicative-noise family
                k = ds.loss_param if ds.loss_param else 2.0
                X[p] = rng.gamma(k, np.maximum(M, 1e-12) / k)
                sigma[p] = 0.0
            else:
                raise ValueError(ds.loss)
        else:  # PAR2 (Frobenius only)
            C = A[ds.modes[2]]
            Bks = A[ds.modes[1]]
            slices = []
            sig = []
            for k in range(C.shape[0]):
                Mk = A[ds.modes[0]] @ np.diag(lam * C[k]) @ Bks[k].T
                Nk = rng.standard_normal(Mk.shape)
                s = noise[p] * np.linalg.norm(Mk) / np.linalg.norm(Nk)
                slices.append(Mk + s * Nk)
                sig.append(s)
            X[p] = slices
            sigma[p] = sig

    data = to_problem_data(spec, X, coupl_trafo, coupl_trafo2, device, dtype)
    return data, A, Delta, sigma


def normalize_data(spec: ProblemSpec, data: ProblemData):
    """Normalize each dataset by its global Frobenius norm
    (example_script1:86-103).  Returns (data, norms per dataset)."""
    objects = list(data.objects)
    norms = []
    for p, ds in enumerate(spec.datasets):
        if ds.model == PAR2:
            X = objects[p]
            nrm = float(torch.sqrt(torch.sum(X.slices ** 2)))
            objects[p] = Parafac2Tensor(X.slices / nrm, X.mask)
        else:
            nrm = float(torch.linalg.norm(objects[p].reshape(-1)))
            objects[p] = objects[p] / nrm
        norms.append(nrm)
    return dataclasses.replace(data, objects=tuple(objects)), norms
