"""The port's data generator (matlab_code_tpu_torch/utils/datagen.py) against
the JAX package's: from the same seed, create_coupled_data gives the same
ground truth, Delta, noise levels and data bit for bit, for every PARAFAC2
Bk style, coupling types 0-5, KL and gamma data, delta_override and
mode_post; normalize_data's norms agree within rtol 1e-15 (a torch
reduction against XLA's).  Float64 on the CPU.
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu import CouplingSpec, DatasetSpec, ProblemSpec
from matlab_code_tpu.utils import datagen as jdatagen

from matlab_code_tpu_torch.convert import spec_from_reference
from matlab_code_tpu_torch.problem import Parafac2Tensor
from matlab_code_tpu_torch.utils import datagen as tdatagen


def _host(obj):
    if isinstance(obj, Parafac2Tensor):
        return obj.slices.numpy(), obj.mask.numpy()
    if isinstance(obj, torch.Tensor):
        return (obj.numpy(),)
    if hasattr(obj, "slices"):
        return np.asarray(obj.slices), np.asarray(obj.mask)
    return (np.asarray(obj),)


def _same(a, b):
    """Bit-equal nested lists/dicts of arrays (None and floats included)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _both(jspec, **kw):
    """(JAX result, port result) of create_coupled_data from one seed, the
    data checked bit for bit on the way."""
    jd, jA, jDelta, jsig = jdatagen.create_coupled_data(jspec, **kw)
    td, tA, tDelta, tsig = tdatagen.create_coupled_data(
        spec_from_reference(jspec), device="cpu", **kw)
    assert len(jd.objects) == len(td.objects)
    for a, b in zip(jd.objects, td.objects):
        for x, y in zip(_host(a), _host(b)):
            assert y.dtype == x.dtype == (bool if x.dtype == bool
                                          else np.float64)
            np.testing.assert_array_equal(y, x)
    for a, b in zip(jd.coupl_trafo + jd.coupl_trafo2,
                    td.coupl_trafo + td.coupl_trafo2):
        _same(None if a is None else np.asarray(a),
              None if b is None else b.numpy())
    _same(jA, tA)
    _same(jDelta, tDelta)
    _same(jsig, tsig)
    return (jd, jA), (td, tA)


def _cp_par2(sizes, coupled=True):
    K = len(sizes)
    return ProblemSpec(
        mode_sizes=(9, 7, 6, 9, tuple(sizes), K),
        datasets=(DatasetSpec("CP", (0, 1, 2), 3, weight=0.5),
                  DatasetSpec("PAR2", (3, 4, 5), 3, weight=0.5)),
        coupling=CouplingSpec((1, 0, 0, 1, 0, 0) if coupled
                              else (0,) * 6, (0,) if coupled else ()))


@pytest.mark.parametrize("bk_style,sizes", [
    ("shift", (8,) * 5), ("temporal", (8,) * 5), ("orth", (6, 8, 7, 9)),
    ("smooth", (6, 8, 7, 9)), ("unimodal", (6, 8, 7, 9))])
def test_torch_create_coupled_data_bk_styles(bk_style, sizes):
    """Every Bk family, CP and PARAFAC2 coupled by type 0 (ragged slices
    where the style takes them), noise 0.3, column normalisation on."""
    (_, jA), (td, tA) = _both(
        _cp_par2(sizes), lambdas=[[1, 2, 3], [1, 1, 1]], noise=0.3,
        distr=["rand", "randn", "randn", "rand", "rand", "rand+0.1"],
        normalize_columns=True, rng=5, bk_style=bk_style)
    assert [b.shape[0] for b in tA[4]] == list(sizes)
    assert td.objects[1].slices.shape == (len(sizes), 9, max(sizes))


def test_torch_create_coupled_data_coupling_types():
    """Coupling types 0-5 between two CP tensors, with their H (and type 5's
    H2), including type 2's refill of an all-zero factor column."""
    rng = np.random.default_rng(3)
    n1, n2 = 6, 12
    H_even = np.zeros((n1, n2))
    H_even[np.arange(n1), 2 * np.arange(n1)] = 1.0
    H2_zero_row = rng.standard_normal((3, 4))
    H2_zero_row[2] = 0.0          # dataset 2's third column comes out zero
    cases = {       # ctype: (I of mode 3, H of modes 0 and 3, H2, ranks)
        0: (n1, None, None, None, (3, 3)),
        1: (n2, np.eye(n1), H_even, None, (3, 3)),
        2: (n1, rng.standard_normal((3, 4)), H2_zero_row, None, (3, 3)),
        3: (n2, rng.standard_normal((n1, 4)), rng.standard_normal((n2, 4)),
            None, (3, 3)),
        4: (n1, np.eye(4, 3), rng.standard_normal((4, 3)), None, (3, 3)),
        5: (n2, np.eye(n1), H_even,
            (np.eye(4), np.vstack([np.eye(3), np.zeros((1, 3))])), (4, 3)),
    }
    for ctype, (I3, H0, H3, H2, ranks) in cases.items():
        jspec = ProblemSpec(
            mode_sizes=(n1, 5, 4, I3, 7, 6),
            datasets=(DatasetSpec("CP", (0, 1, 2), ranks[0], weight=0.5),
                      DatasetSpec("CP", (3, 4, 5), ranks[1], weight=0.5)),
            coupling=CouplingSpec((1, 0, 0, 1, 0, 0), (ctype,)))
        ct = None if H0 is None else [H0, None, None, H3, None, None]
        ct2 = None if H2 is None else [H2[0], None, None, H2[1], None, None]
        (_, jA), _ = _both(jspec, lambdas=[[1] * ranks[0], [1] * ranks[1]],
                           noise=0.1, distr=["rand"] * 6, coupl_trafo=ct,
                           coupl_trafo2=ct2, rng=11 + ctype)
        if ctype == 2:
            assert np.all(jA[3][:, 2] != 0)     # refilled


def test_torch_create_coupled_data_losses_override_post():
    """KL (Poisson) and IS / beta (gamma) data from gamma factors, a
    callable distr, delta_override of a type-4 coupling and a simplex
    mode_post hook."""
    jspec = ProblemSpec(
        mode_sizes=(8, 6, 5, 8, 7),
        datasets=(DatasetSpec("CP", (0, 1, 2), 3, weight=0.5, loss="KL"),
                  DatasetSpec("CP", (3, 4), 3, weight=0.5, loss="IS")),
        coupling=CouplingSpec((1, 0, 0, 1, 0), (0,)))
    _both(jspec, lambdas=[[1, 1, 1], [1, 1, 1]], noise=0.0,
          distr=[("gamma", 1.0, 1.0)] * 5, rng=2)
    jspec_b = ProblemSpec(
        mode_sizes=(8, 6, 5), datasets=(DatasetSpec(
            "CP", (0, 1, 2), 2, loss="beta", loss_param=1.5),),
        coupling=CouplingSpec((0, 0, 0), ()))
    pw = lambda rng, shape: np.cumsum(rng.uniform(size=shape), axis=0)
    _both(jspec_b, lambdas=[[1, 1]], noise=0.0,
          distr=[pw, ("gamma", 2.0, 0.5), "rand"], rng=4,
          mode_post={2: lambda A: A / A.sum(axis=0, keepdims=True)})
    jspec4 = ProblemSpec(
        mode_sizes=(7, 6, 5, 7, 9),
        datasets=(DatasetSpec("CP", (0, 1, 2), 3, weight=0.5),
                  DatasetSpec("CP", (3, 4), 2, weight=0.5)),
        coupling=CouplingSpec((1, 0, 0, 1, 0), (4,)))
    D = np.random.default_rng(9).uniform(size=(7, 4))
    (_, jA), (_, tA) = _both(
        jspec4, lambdas=[[1] * 3, [1] * 2], noise=0.05, distr=["rand"] * 5,
        coupl_trafo=[np.eye(4, 3), None, None, np.eye(4, 2), None],
        delta_override={1: D}, rng=6)
    np.testing.assert_array_equal(tA[0], D @ np.eye(4, 3))


def test_torch_normalize_data():
    """Each dataset over its global Frobenius norm: the norms and the data
    within rtol 1e-15 of the JAX package's, the PARAFAC2 mask unchanged."""
    jspec = _cp_par2((6, 8, 7, 9))
    kw = dict(lambdas=[[1, 1, 1], [1, 1, 1]], noise=0.2,
              distr=["rand", "randn", "randn", "rand", "rand", "rand+0.1"],
              rng=8, bk_style="orth")
    (jd, _), (td, _) = _both(jspec, **kw)
    jd, jn = jdatagen.normalize_data(jspec, jd)
    td, tn = tdatagen.normalize_data(spec_from_reference(jspec), td)
    np.testing.assert_allclose(tn, jn, rtol=1e-15, atol=0)
    for a, b in zip(jd.objects, td.objects):
        x, y = _host(a), _host(b)
        np.testing.assert_allclose(y[0], x[0], rtol=1e-15, atol=1e-300)
        for u, v in zip(x[1:], y[1:]):
            np.testing.assert_array_equal(v, u)
    with pytest.raises(ValueError, match="equal PARAFAC2 slice"):
        tdatagen.create_coupled_data(spec_from_reference(jspec), device="cpu",
                                     **dict(kw, bk_style="shift"))
