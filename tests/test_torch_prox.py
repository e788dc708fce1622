"""The port's proxes (matlab_code_tpu_torch/ops/prox.py, ops/isotonic.py,
ops/tv.py) against the JAX package's, on the CPU in float64.

The sequential proxes (monotone, unimodal, TV) take their plain versions
here: Python walks of each column in the JAX module's order of merges and
arithmetic, which the CUDA kernels of csrc/prox_seq.cu also follow
(tests/test_torch_prox_cuda.py holds the kernels to them on the card).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matlab_code_tpu.ops import prox as jprox
from matlab_code_tpu.ops.isotonic import project_monotone as jmonotone
from matlab_code_tpu.ops.isotonic import project_unimodal as junimodal
from matlab_code_tpu.ops.tv import prox_tv as jprox_tv

from matlab_code_tpu_torch.convert import (
    constraint_from_reference, spec_from_reference)
from matlab_code_tpu_torch.ops import isotonic as tiso
from matlab_code_tpu_torch.ops import prox as tprox
from matlab_code_tpu_torch.ops import prox_cuda
from matlab_code_tpu_torch.ops import tv as ttv

QUAD_L = np.array([[2.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                   [-1.0, 3.0, -1.0, 0.0, 0.0, 0.0, 0.0],
                   [0.0, -1.0, 2.0, -0.5, 0.0, 0.0, 0.0],
                   [0.0, 0.0, -0.5, 1.5, 0.0, 0.0, 0.0],
                   [0.0, 0.0, 0.0, 0.0, 1.0, 0.2, 0.0],
                   [0.0, 0.0, 0.0, 0.0, 0.2, 1.0, 0.0],
                   [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5]])

KINDS = [
    ("non-negativity", ()), ("box", (-0.2, 0.3)),
    ("simplex column-wise", (1.0,)), ("simplex row-wise", (2.0,)),
    ("non-decreasing", ()), ("non-increasing", ()),
    ("unimodality", (0,)), ("unimodality", (1,)),
    ("l1-ball", (1.5,)), ("l2-ball", (1.0,)), ("non-negative l2-ball", (1.0,)),
    ("non-negative l2-sphere", ()), ("orthonormal", ()),
    ("l1 regularization", (0.1,)), ("l0 regularization", (0.05,)),
    ("l2 regularization", (0.3,)), ("ridge", (0.2,)),
    ("quadratic regularization", (0.5,)), ("GL smoothness", (0.7,)),
    ("TV regularization", (0.05,)),
    ("TV regularization", (0.0,)),       # lam = 0: y itself
    ("TV regularization", (100.0,)),     # lam above every column's TV: means
]


def _matrices(n, R=5, seed=3):
    """A normal (n, R) matrix with a constant column, an all-negative
    column and a column of ties (values on a 0.5 grid)."""
    rng = np.random.default_rng(seed + n)
    X = rng.standard_normal((n, R))
    X[:, 1] = 0.3
    X[:, 2] = -np.abs(X[:, 2]) - 0.1
    X[:, 3] = np.round(2 * X[:, 3]) / 2
    return X


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-14)


@pytest.mark.parametrize("kind,params", KINDS)
def test_torch_every_prox_and_reg_matches_jax(kind, params):
    """make_prox of each ported kind against the JAX package's: the prox at
    two rho (a number and a 0-d tensor), and the reg term, at n = 1 and 29
    (n = 7 for 'quadratic regularization', whose L is 7 x 7)."""
    sizes = (7,) if kind == "quadratic regularization" else (1, 29)
    for n in sizes:
        matrix = QUAD_L if kind == "quadratic regularization" else None
        jp, jreg = jprox.make_prox(jprox.ConstraintSpec(kind, params, matrix), n)
        tp_, treg = tprox.make_prox(
            tprox.ConstraintSpec(kind, params, matrix), n)
        assert (jreg is None) == (treg is None)
        X = _matrices(n)
        for rho in (1.0, 0.37):
            want = jp(jnp.asarray(X), rho)
            _close(tp_(torch.tensor(X), rho), want)
            _close(tp_(torch.tensor(X), torch.tensor(rho, dtype=torch.float64)),
                   want)
        if treg is not None:
            _close(treg(torch.tensor(X)), jreg(jnp.asarray(X)))


def test_torch_tv_reg_keeps_the_reference_sign():
    """The TV penalty is eta * sum(diff(x)) without abs, as the reference
    writes it (constraints_to_prox.m:81): a decreasing column counts
    negative."""
    _, reg = tprox.make_prox(tprox.ConstraintSpec("TV regularization", (2.0,)),
                             3)
    x = torch.tensor([[3.0], [2.0], [0.0]], dtype=torch.float64)
    assert float(reg(x)) == -6.0


def test_torch_custom_prox_takes_torch_functions():
    spec = tprox.ConstraintSpec(
        "custom", fns=(lambda x, rho: x.clamp(max=rho),
                       lambda x: torch.sum(x)))
    prox, reg = tprox.make_prox(spec, 3)
    x = torch.tensor([[0.5, 2.0], [1.5, -1.0]], dtype=torch.float64)
    assert torch.equal(prox(x, 1.0), x.clamp(max=1.0))
    assert float(reg(x)) == 3.0
    prox, reg = tprox.make_prox(tprox.ConstraintSpec(
        "custom", fns=(lambda x, rho: x,)), 3)
    assert reg is None


def test_torch_every_known_kind_is_ported_or_names_its_slice():
    """Every kind of KNOWN_CONSTRAINT_KINDS builds a prox (the kind sets are
    the JAX package's): the matrix kinds on a (7, 5) matrix, 'tPARAFAC2' on
    a (3, 7, 5) stack of slices with one rho a slice."""
    assert tprox.KNOWN_CONSTRAINT_KINDS == jprox.KNOWN_CONSTRAINT_KINDS
    params = {k: p for k, p in KINDS}
    for kind in sorted(tprox.KNOWN_CONSTRAINT_KINDS):
        if kind == "tPARAFAC2":
            prox, reg = tprox.make_prox(tprox.ConstraintSpec(kind, (1.0,)), 7)
            Bs = torch.tensor(np.stack([_matrices(7)] * 3))
            assert prox(Bs, torch.ones(3, dtype=torch.float64)).shape == (3, 7, 5)
            assert float(reg(Bs)) == 0.0
            continue
        spec = tprox.ConstraintSpec(
            kind, params.get(kind, ()),
            QUAD_L if kind == "quadratic regularization" else None,
            ((lambda x, rho: x),) if kind == "custom" else ())
        prox, _ = tprox.make_prox(spec, 7)
        assert prox(torch.tensor(_matrices(7)), 1.0).shape == (7, 5)


def test_torch_quadratic_operators_take_the_data_dtype():
    """The operator matrix of 'GL smoothness' and 'quadratic
    regularization' is made in the dtype (and on the device) of the x it is
    called with, so a float32 fit never mixes in a float64 matrix, and one
    prox serves a float64 x after a float32 one."""
    for kind, matrix in (("GL smoothness", None),
                         ("quadratic regularization", QUAD_L)):
        prox, reg = tprox.make_prox(tprox.ConstraintSpec(kind, (0.5,), matrix),
                                    7)
        x = torch.tensor(_matrices(7), dtype=torch.float32)
        assert prox(x, 1.0).dtype == torch.float32
        assert reg(x).dtype == torch.float32
        x64 = torch.tensor(_matrices(7))
        assert prox(x64, 1.0).dtype == torch.float64
        assert reg(x64).dtype == torch.float64
        _close(prox(x, 1.0), prox(x64, 1.0), 1e-5)
    L = tprox.gl_smoothness_matrix(5)
    np.testing.assert_array_equal(L.numpy(),
                                  np.asarray(jprox.gl_smoothness_matrix(5)))


@pytest.mark.parametrize("n", [1, 2, 3, 29, 256])
def test_torch_plain_sequential_proxes_match_jax(n):
    """The plain isotonic, unimodal and TV walks against the JAX modules,
    bit for bit in float64 (the same merges and arithmetic in the same
    order), on normal columns, a constant column, an all-negative column
    and ties."""
    X = _matrices(n)
    T = torch.tensor(X)
    for inc in (True, False):
        np.testing.assert_array_equal(tiso.project_monotone(T, inc).numpy(),
                                      np.asarray(jmonotone(jnp.asarray(X), inc)))
    for nn in (False, True):
        np.testing.assert_array_equal(tiso.project_unimodal(T, nn).numpy(),
                                      np.asarray(junimodal(jnp.asarray(X), nn)))
    tv_x = float(np.max(np.sum(np.abs(np.diff(X, axis=0)), axis=0)))
    for lam in (0.0, 0.01, 0.3, 2.0, tv_x + 1.0):
        np.testing.assert_array_equal(ttv.prox_tv(T, lam).numpy(),
                                      np.asarray(jprox_tv(jnp.asarray(X), lam)))
    assert tiso.project_unimodal(T, True).min() >= 0


def test_torch_plain_sequential_proxes_match_native():
    """Against the sequential C++ goldens of native/kernels.cc, the way
    tests/test_native.py holds the JAX modules to them."""
    native = pytest.importorskip("native")
    rng = np.random.default_rng(11)
    for n in (6, 17, 40):
        y = rng.standard_normal(n)
        col = torch.tensor(y)
        for lam in (0.05, 0.4, 3.0):
            np.testing.assert_allclose(ttv.tv_denoise_vector(col, lam).numpy(),
                                       native.tv_denoise(y, lam), atol=1e-12)
        for inc in (True, False):
            np.testing.assert_allclose(
                tiso.isotonic_vector(col, inc).numpy(),
                native.isotonic(y, increasing=inc), atol=1e-12)
        for nn in (False, True):
            np.testing.assert_allclose(tiso.unimodal_vector(col, nn).numpy(),
                                       native.unimodal(y, nn), atol=1e-12)


def test_torch_sequential_proxes_keep_dtype_and_count_steps():
    """A float32 CPU matrix is walked in float64 and rounded once (as the
    kernels do); the walks report their dependent steps (the bound of the
    kernels in chip_smoke.py), at least one a row."""
    X = _matrices(40)
    want = tiso.columns_reference(torch.tensor(X), tiso.UNIMODAL, True)
    X32 = torch.tensor(X, dtype=torch.float32)
    got = tiso.project_unimodal(X32, True)
    assert got.dtype == torch.float32
    ref = tiso.columns_reference(X32.double(), tiso.UNIMODAL, True)
    np.testing.assert_array_equal(got.numpy(), ref.float().numpy())
    steps = []
    tiso.columns_reference(torch.tensor(X), tiso.UNIMODAL, True, steps)
    assert len(steps) == 2 * 5 and min(steps) >= 40
    assert np.abs(want.numpy() - ref.numpy()).max() < 1e-6
    steps = []
    ttv.columns_reference(torch.tensor(X), 0.1, steps)
    assert len(steps) == 5 and min(steps) >= 40 - 1
    steps = []
    ttv.columns_reference(torch.tensor(X), 0.0, steps)
    assert steps == [0] * 5


def test_torch_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: the plain versions serve
    the CPU, through project_monotone / project_unimodal / prox_tv."""
    X = torch.tensor(_matrices(7))
    with pytest.raises(ValueError, match="CUDA"):
        prox_cuda.project_isotonic_cols(X, tiso.INCREASING)
    with pytest.raises(ValueError, match="CUDA"):
        prox_cuda.prox_tv_cols(X, 0.1)
    assert prox_cuda._LIB is None


def test_torch_constraint_specs_cross_from_the_jax_package():
    """convert carries every kind with its params, the matrix as a numpy
    array; a 'custom' spec (jnp functions) raises."""
    for kind, params in KINDS:
        matrix = (jnp.asarray(QUAD_L) if kind == "quadratic regularization"
                  else None)
        c = constraint_from_reference(jprox.ConstraintSpec(kind, params, matrix))
        assert (c.kind, c.params) == (kind, params)
        if matrix is not None:
            assert isinstance(c.matrix, np.ndarray)
            np.testing.assert_array_equal(c.matrix, QUAD_L)
    assert constraint_from_reference(None) is None
    with pytest.raises(ValueError, match="custom"):
        constraint_from_reference(
            jprox.ConstraintSpec("custom", fns=(lambda x, rho: x,)))
    from matlab_code_tpu import ProblemSpec, DatasetSpec
    spec = ProblemSpec(mode_sizes=(4, 5),
                       datasets=(DatasetSpec(model="CP", modes=(0, 1), rank=2),),
                       constraints=(jprox.ConstraintSpec("l1-ball", (2.0,)),
                                    jprox.ConstraintSpec("tPARAFAC2", (1.0,))))
    tspec = spec_from_reference(spec)
    assert [c.kind for c in tspec.constraints] == ["l1-ball", "tPARAFAC2"]
