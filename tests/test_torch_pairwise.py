"""The port's pairwise-perturbation MTTKRP (models/pairwise.py) against the
JAX package: which datasets take it, the partials and the first-order
MTTKRP from the same references, its error's first-order scaling,
pp_start_tol = 0 against the exact fit, and dense and sparse PP fits
against the JAX PP fit (streams, the sweep that switches the
approximation on and the rebuilds).  Everything runs in float64 on the
CPU; the problems are tests/test_pairwise.py's.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models import pairwise as jpw
from matlab_code_tpu.models import solver as jsolver
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.problem import SparseTensor as JSparseTensor
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models import pairwise as tpw
from matlab_code_tpu_torch.models.admm import to_host
from matlab_code_tpu_torch.ops.tensor import mttkrp

STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl")


def _problem(layout="dense", noise=0.02):
    """tests/test_pairwise.py's 20x30x40 rank-3 problem (non-negative mode
    0); the sparse layout zeroes 40 % of the noise-free tensor."""
    spec = ProblemSpec(
        mode_sizes=(20, 30, 40),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("non-negativity"), None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1, 1]], noise=noise if layout == "dense" else 0.0,
        distr=["rand", "randn", "randn"], rng=7)
    data, _ = normalize_data(spec, data)
    if layout == "sparse":
        X = np.array(data.objects[0])
        X[np.random.default_rng(4).uniform(size=X.shape) < 0.4] = 0.0
        data = dataclasses.replace(data,
                                   objects=(JSparseTensor.from_dense(X),))
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1, 1),))
    return spec, data, init_coupled(spec, data, init, key=1)


def _to_port(spec, data, state):
    return (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            state_from_numpy(state, device="cpu"))


def test_torch_pp_eligibility():
    """Dense and COO 3-way Frobenius CP datasets are eligible; none without
    the option, with a missing mask (EM changes the data under the
    partials), for a matrix or for a KL dataset; the JAX rule without its
    mesh."""
    on = tp.AlgOptions(cp_pairwise_perturbation=True)
    for layout in ("dense", "sparse"):
        spec, data, state = _problem(layout)
        tspec, tdata, _ = _to_port(spec, data, state)
        assert tpw.eligible_pp_datasets(tspec, tdata, on) == (0,) == \
            jpw.eligible_pp_datasets(spec, data, options_to_jax(on))
        assert tpw.eligible_pp_datasets(tspec, tdata, tp.AlgOptions()) == ()
    miss = dataclasses.replace(tdata, miss=(torch.ones((20, 30, 40),
                                                       dtype=torch.bool),))
    assert tpw.eligible_pp_datasets(tspec, miss, on) == ()
    mat = tp.ProblemSpec(mode_sizes=(4, 5),
                         datasets=(tp.DatasetSpec("CP", (0, 1), 2),))
    assert tpw.eligible_pp_datasets(
        mat, tp.ProblemData(objects=(torch.ones((4, 5)),)), on) == ()
    kl = dataclasses.replace(tspec, datasets=(dataclasses.replace(
        tspec.datasets[0], loss="KL"),))
    assert tpw.eligible_pp_datasets(kl, tdata, on) == ()


def options_to_jax(opts):
    return AlgOptions(cp_pairwise_perturbation=opts.cp_pairwise_perturbation)


def _perturbed(facs, eps, seed=0):
    """facs + eps * d with d of unit norm relative to each factor."""
    rng = np.random.default_rng(seed)
    out = []
    for f in facs:
        g = rng.standard_normal(f.shape)
        out.append(f + eps * g / np.linalg.norm(g) * np.linalg.norm(f))
    return out


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_torch_pp_mttkrp_matches_jax(layout):
    """The partials built from the same references (einsum, or the segment
    sum of a COO tensor) and the first-order MTTKRP of every mode at
    perturbed factors, against the JAX functions at rtol 1e-12; an
    inactive cache takes the exact MTTKRP."""
    spec, data, state = _problem(layout)
    tspec, tdata, tstate = _to_port(spec, data, state)
    refs = tuple(np.array(state.fac[m]) for m in range(3))
    jparts = jpw._build_partials(spec, data, 0, tuple(map(jnp.asarray, refs)))
    tparts = tpw._build_partials(tspec, tdata, 0,
                                 tuple(map(torch.from_numpy, refs)))
    for a, b in zip(tparts, jparts):   # the port's (R, a, b), JAX's (a, b, R)
        assert a.is_contiguous()
        np.testing.assert_allclose(a.permute(1, 2, 0).numpy(), np.asarray(b),
                                   rtol=1e-12, atol=1e-14)
    names = ("T01", "T02", "T12")
    jcache = dict(zip(names, jparts), ref0=jnp.asarray(refs[0]),
                  ref1=jnp.asarray(refs[1]), ref2=jnp.asarray(refs[2]),
                  active=jnp.bool_(True), seeded=jnp.bool_(True))
    tcache = dict(zip(names, tparts), ref0=torch.from_numpy(refs[0]),
                  ref1=torch.from_numpy(refs[1]),
                  ref2=torch.from_numpy(refs[2]), active=True, seeded=True)
    facs = _perturbed(refs, 0.03)
    jX, tX = data.objects[0], tdata.objects[0]
    for local in range(3):
        want = jpw.pp_mttkrp(spec, jX, tuple(map(jnp.asarray, facs)), 0,
                             jcache, local, AlgOptions())
        got = tpw.pp_mttkrp(tspec, tX, tuple(map(torch.from_numpy, facs)), 0,
                            tcache, local)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-14)
        exact = tpw.pp_mttkrp(tspec, tX, tuple(map(torch.from_numpy, facs)),
                              0, dict(tcache, active=False), local)
        want = jpw.pp_mttkrp(spec, jX, tuple(map(jnp.asarray, facs)), 0,
                             dict(jcache, active=jnp.bool_(False)), local,
                             AlgOptions())
        np.testing.assert_allclose(exact.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)


def test_torch_pp_first_order_error_scaling():
    """The first-order MTTKRP's error is O(||perturbation||^2): it
    quarters where the perturbation halves (test_pairwise.py's check)."""
    spec, data, state = _problem()
    tspec, tdata, tstate = _to_port(spec, data, state)
    refs = tuple(tstate.fac)
    T01, T02, T12 = tpw._build_partials(tspec, tdata, 0, refs)
    cache = {"T01": T01, "T02": T02, "T12": T12, "ref0": refs[0],
             "ref1": refs[1], "ref2": refs[2], "active": True,
             "seeded": True}
    X = tdata.objects[0]

    def err(eps):
        facs = [torch.from_numpy(f) for f in _perturbed(
            [f.numpy() for f in refs], eps, seed=4)]
        return max(float(torch.linalg.norm(
            tpw.pp_mttkrp(tspec, X, facs, 0, cache, local)
            - mttkrp(X, facs, local)) / torch.linalg.norm(
                mttkrp(X, facs, local))) for local in range(3))

    e1, e2 = err(0.02), err(0.04)
    assert e1 < 0.05
    assert e2 / e1 == pytest.approx(4.0, rel=0.35)


def test_torch_pp_never_active_is_exact():
    """pp_start_tol = 0 never switches the approximation on: every stream
    is the exact fit's bit for bit, except the last entry, recomputed by
    the exact final evaluation (rtol 1e-10), and so are the factors; the
    gate reads the device once a sweep from the second on."""
    spec, data, state = _problem()
    tspec, tdata, tstate = _to_port(spec, data, state)
    opts = tp.AlgOptions(MaxOuterIters=30, AbsFuncTol=0.0, OuterRelTol=0.0)
    opts_pp = dataclasses.replace(opts, cp_pairwise_perturbation=True,
                                  pp_start_tol=0.0)
    to_host.calls = 0
    s1, o1 = tp.fit(tspec, tdata, tstate, opts)
    reads = to_host.calls
    tpw.reset_counts()
    to_host.calls = 0
    s2, o2 = tp.fit(tspec, tdata, tstate, opts_pp)
    assert to_host.calls == reads + 29 + 1   # the gate, the exact last entry
    assert tpw.pp_sweep_update.sweeps == 30
    assert tpw.pp_sweep_update.active == tpw.pp_sweep_update.rebuilds == 0
    for s in STREAMS:
        np.testing.assert_array_equal(getattr(o1, s)[:-1], getattr(o2, s)[:-1])
    np.testing.assert_allclose(o1.func_val_conv[-1], o2.func_val_conv[-1],
                               rtol=1e-10)
    np.testing.assert_array_equal(o1.innerIters, o2.innerIters)
    for m in range(3):
        assert torch.equal(s1.fac[m], s2.fac[m])


def _jax_pp_fit(spec, data, state0, opts, monkeypatch):
    """The JAX PP fit and the sweeps (from 1) at which it built partials,
    recorded by ordered debug callbacks in its sweep gate and build
    branch (the runner cache emptied so the callbacks are traced)."""
    events = []
    build, update = jpw._build_partials, jpw.pp_sweep_update

    def build_rec(*a):
        jax.debug.callback(lambda: events.append("B"), ordered=True)
        return build(*a)

    def update_rec(*a):
        jax.debug.callback(lambda: events.append("S"), ordered=True)
        return update(*a)

    monkeypatch.setattr(jpw, "_build_partials", build_rec)
    monkeypatch.setattr(jpw, "pp_sweep_update", update_rec)
    monkeypatch.setattr(jsolver, "_RUNNER_CACHE", {})
    _, out = jsolver.fit(spec, data, state0, opts)
    jax.effects_barrier()
    sweeps, builds = 0, []
    for e in events:
        if e == "S":
            sweeps += 1
        else:
            builds.append(sweeps)
    return out, builds


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_torch_pp_fit_matches_jax(layout, monkeypatch):
    """80 outer iterations with cp_pairwise_perturbation at the default
    tolerances, dense (noise 0.02) and COO: every stream at rtol 1e-8
    (the last entry the exact final objective), innerIters equal, the
    approximation switched on at the same sweep and rebuilt as often."""
    spec, data, state0 = _problem(layout)
    opts = AlgOptions(MaxOuterIters=80, AbsFuncTol=0.0, OuterRelTol=0.0,
                      cp_pairwise_perturbation=True)
    ref, builds = _jax_pp_fit(spec, data, state0, opts, monkeypatch)
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    tpw.reset_counts()
    st, out = tp.fit(tspec, tdata, tstate0, options_from_reference(opts))
    assert len(builds) >= 2 and builds[0] > 1   # switched on, then rebuilt
    assert tpw.pp_sweep_update.first_active == builds[0]
    assert tpw.pp_sweep_update.rebuilds == len(builds)
    assert tpw.pp_sweep_update.active == 80 - builds[0] + 1
    for s in STREAMS:
        np.testing.assert_allclose(getattr(out, s), getattr(ref, s),
                                   rtol=1e-8, atol=1e-14, err_msg=s)
    np.testing.assert_array_equal(out.innerIters, ref.innerIters)
    assert all(np.all(np.isfinite(f)) for f in state_to_numpy(st)["fac"])
