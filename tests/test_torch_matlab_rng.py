"""The port's MATLAB-stream replay (matlab_code_tpu_torch/utils/matlab_rng.py)
against the JAX package's: the twister's rand, the ziggurat randn with its
slow-path counters, randi and randperm give the same draws; from the same
seed matlab_create_coupled_data gives the same ground truth and data bit
for bit; and the reference-seeded replays of scripts 03, 09, 12 and 13
hand the fit the same data and init.  There two things round: the data
are normalized by a norm that a torch reduction sums (up to 560,000
squares) in another order than XLA's, and the constraint auxiliaries go
through the port's proxes (the non-negative l2-sphere's norm, the unimodal
prox); both are held at rtol 1e-14.  Every other array of the init is
drawn and must be the same bits.  Float64 on the CPU.
"""
import importlib

import numpy as np
import pytest

from matlab_code_tpu.utils import matlab_rng as jrng

from matlab_code_tpu_torch.convert import spec_from_reference, state_to_numpy
from matlab_code_tpu_torch.examples import common as tcommon
from matlab_code_tpu_torch.problem import Parafac2Tensor
from matlab_code_tpu_torch.utils import matlab_rng as trng


def test_torch_matlab_rng_streams():
    """rand, randn (slow paths included: 40000 normal draws hit both), randi,
    randperm and their interleaving, from three seeds."""
    for seed in ("default", 0, 4):
        a, b = jrng.MatlabRNG(seed), trng.MatlabRNG(seed)
        for draw in (lambda g: g.rand(7, 5), lambda g: g.randn(40000),
                     lambda g: g.randi(60, 4), lambda g: g.randperm(50, 10),
                     lambda g: g.randn(3, 9), lambda g: g.randperm(12),
                     lambda g: g.rand(3)):
            np.testing.assert_array_equal(draw(b), draw(a))
        assert (b.slowpath_edge, b.slowpath_tail) == (
            a.slowpath_edge, a.slowpath_tail)
        assert b.slowpath_edge > 0 and b.slowpath_tail > 0
        np.testing.assert_array_equal(b._mt, a._mt)
        assert b._pos == a._pos
    assert trng.MatlabRNG().rand(1)[0] == pytest.approx(0.814723686393179,
                                                        rel=1e-15)


@pytest.mark.parametrize("runs", [
    [("script01a_cp_par2_smooth_l2ball",
      dict(noise=0.5, bk_style="smooth", seed=5))],
    [("script04_irregular_par2", dict(noise=0.2, bk_style="orth"))],
    [("script05_cp_cp_doublesampling_simplex",
      dict(noise=0.2, case1_max_override=False)),
     ("script14_cp_par2_couplC", dict(noise=0.0))]],
    ids=["smooth", "orth", "type1"])
def test_torch_matlab_create_coupled_data(runs):
    """The smooth and orthonormal Bk, type 1 with and without the
    largest-mode override (a PARAFAC2 C mode in script 14), a draw-consuming
    post hook: the ground truth, Delta, data and the stream position after
    the call, bit for bit."""
    for mod, kw in runs:
        _hold_create(mod, kw)


def _hold_create(mod, kw):
    cfg = importlib.import_module(f"examples.{mod}").build()
    hook = None
    if mod.startswith("script05"):
        def hook(A, rng):
            A[5] = A[5] / A[5].sum(axis=0, keepdims=True)
            rng.rand(2)
    out = []
    for pkg, spec, extra in ((jrng, cfg["spec"], {}),
                             (trng, spec_from_reference(cfg["spec"]),
                              {"device": "cpu"})):
        data, A, Delta, rng = pkg.matlab_create_coupled_data(
            spec, cfg["distr"], cfg["lambdas"],
            coupl_trafo=cfg.get("coupl_trafo"), post_uncoupled=hook,
            **kw, **extra)
        objs = []
        for X in data.objects:
            if isinstance(X, Parafac2Tensor):
                objs += [X.slices.numpy(), X.mask.numpy()]
            elif hasattr(X, "slices"):
                objs += [np.asarray(X.slices), np.asarray(X.mask)]
            else:
                objs.append(np.asarray(X))
        out.append((objs, A, Delta, rng.rand(4)))
    (jo, jA, jD, jnext), (to, tA, tD, tnext) = out
    for x, y in zip(jo, to):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)
    for x, y in zip(jA, tA):        # a Bk mode is a list of slices
        for u, v in zip(*((x, y) if isinstance(x, list) else ([x], [y]))):
            np.testing.assert_array_equal(v, u)
    assert sorted(jD) == sorted(tD)
    for k in jD:
        np.testing.assert_array_equal(tD[k], jD[k])
    np.testing.assert_array_equal(tnext, jnext)


class _Fit(Exception):
    """Raised in place of the fit: carries the replay's data and init."""


@pytest.mark.parametrize("mod", [
    "script03_matrix_cp_partialcoupling", "script09_par2_unimodality",
    "script12_cp_par2_em", "script13_cp_cp_type5"])
def test_torch_reference_seeded_inputs(mod, monkeypatch):
    """The data and init each package's run_reference hands its fit: script
    03 (type 4, rng(4) then rng(13), the non-negative l2-sphere), 09 (the
    unimodal Bk prox in the init, the bumps' post hook), 12 (the randperm
    missing masks in column-major order) and 13 (type 5, rng(1) before the
    init, the Delta shape)."""
    import matlab_code_tpu.models.solver as jsolver

    def capture(spec, data, options, init=None, **kw):
        raise _Fit(data, init)

    monkeypatch.setattr(jsolver, "cmtf_aoadmm", capture)
    monkeypatch.setattr(tcommon, "cmtf_aoadmm", capture)
    got = []
    for pkg, kw in (("examples", {}),
                    ("matlab_code_tpu_torch.examples", {"device": "cpu"})):
        with pytest.raises(_Fit) as e:
            importlib.import_module(f"{pkg}.{mod}").run_reference(
                verbose=False, **kw)
        got.append(e.value.args)
    (jdata, jinit), (tdata, tinit) = got
    for a, b in zip(jdata.objects, tdata.objects):
        if isinstance(b, Parafac2Tensor):
            np.testing.assert_allclose(b.slices.numpy(), np.asarray(a.slices),
                                       rtol=1e-14, atol=1e-300)
            np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14,
                                       atol=1e-300)
    for a, b in zip(jdata.miss, tdata.miss):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if mod.startswith("script12"):
        assert all(m is not None and not m.all() for m in tdata.miss)
    tstate = state_to_numpy(tinit)
    for field, arrays in tstate.items():
        for m, (x, y) in enumerate(zip(getattr(jinit, field), arrays)):
            assert (x is None) == (y is None), (field, m)
            if x is None:
                continue
            x = np.asarray(x)
            assert y.shape == x.shape and y.dtype == np.float64
            if field == "constraint_fac":
                np.testing.assert_allclose(y, x, rtol=1e-14, atol=1e-300,
                                           err_msg=f"{field}[{m}]")
            else:
                np.testing.assert_array_equal(y, x, err_msg=f"{field}[{m}]")
