"""The port's dense tensor operations (matlab_code_tpu_torch.ops.tensor) and
the MTTKRP kernel module (ops.mttkrp_cuda) against the JAX package.

On the CPU the kernel's wrapper takes its plain version; the kernel itself
runs only on a CUDA card: tests/test_torch_kernel_cuda.py and chip_smoke.py
compare it with the plain version there.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from matlab_code_tpu.ops import tensor as jt
from matlab_code_tpu.ops.mttkrp_pallas import mttkrp3_mode0

from matlab_code_tpu_torch.ops import tensor as tt
from matlab_code_tpu_torch.ops.mttkrp_cuda import (
    R_MAX, column_blocks, mttkrp3, mttkrp3_reference, plan_mttkrp3)


def _factors(rng, shape, R, dtype=np.float64):
    return [rng.standard_normal((n, R)).astype(dtype) for n in shape]


@pytest.mark.parametrize("shape,mode", [
    ((7, 5, 6), 0), ((7, 5, 6), 1), ((7, 5, 6), 2), ((9, 4), 0), ((9, 4), 1)])
def test_torch_mttkrp_matches_jax(shape, mode):
    rng = np.random.default_rng(0)
    X = rng.standard_normal(shape)
    facs = _factors(rng, shape, 3)
    want = np.asarray(jt.mttkrp(jnp.asarray(X), [jnp.asarray(f) for f in facs],
                                mode))
    got = tt.mttkrp(torch.tensor(X), [torch.tensor(f) for f in facs], mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)


def test_torch_mttkrp_mode0_matches_pallas_interpret():
    """The shapes of tests/test_solver_features.py::test_pallas_mttkrp_interpret,
    in float32; rtol 1e-5 covers float32 sums of J*K = 8192 terms in
    another order.  Entries near zero (cancellation) carry the same absolute
    rounding, so the bound is also 1e-5 of the largest entry in absolute
    terms."""
    rng = np.random.default_rng(0)
    I, J, K, R = 16, 128, 64, 8
    X = rng.standard_normal((I, J, K)).astype(np.float32)
    B = rng.standard_normal((J, R)).astype(np.float32)
    C = rng.standard_normal((K, R)).astype(np.float32)
    want = np.asarray(mttkrp3_mode0(jnp.asarray(X), jnp.asarray(B),
                                    jnp.asarray(C), interpret=True))
    A = torch.zeros((I, R), dtype=torch.float32)
    got = tt.mttkrp(torch.tensor(X), [A, torch.tensor(B), torch.tensor(C)], 0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_mttkrp3_cpu_takes_plain_version(mode):
    rng = np.random.default_rng(1)
    shape = (5, 3, 13)
    X = torch.tensor(rng.standard_normal(shape))
    facs = [torch.tensor(f) for f in _factors(rng, shape, 4)]
    before = mttkrp3.launches
    got = mttkrp3(X, facs, mode)
    assert mttkrp3.launches == before   # no kernel launched on the CPU
    torch.testing.assert_close(got, mttkrp3_reference(X, facs, mode),
                               rtol=0, atol=0)
    want = np.asarray(jt.mttkrp(jnp.asarray(X.numpy()),
                                [jnp.asarray(f.numpy()) for f in facs], mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)


def test_torch_mttkrp3_reference_promotes_to_float32():
    X = torch.ones((2, 3, 4), dtype=torch.float16)
    facs = [torch.ones((n, 2), dtype=torch.float16) for n in (2, 3, 4)]
    out = mttkrp3_reference(X, facs, 2)
    assert out.dtype == torch.float32 and out.shape == (4, 2)
    assert torch.all(out == 6.0)


def test_torch_mttkrp3_rejects_other_devices():
    X = torch.empty((2, 3, 4), device="meta")
    facs = [torch.empty((n, 2), device="meta") for n in (2, 3, 4)]
    with pytest.raises(ValueError, match="device"):
        mttkrp3(X, facs, 0)


@pytest.mark.parametrize("shape,R", [
    ((128, 512, 256), 16), ((128, 1024, 64), 20), ((37, 50, 29), 7),
    ((5, 3, 130), 1), ((1, 1, 1), 32), ((3, 70000, 2), 9)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_mttkrp3_plan_covers_every_row(shape, R, mode):
    """The launch plan of csrc/mttkrp3.cu: splits cover the split axes with
    no empty split, the factor tile fits its shared-memory budget and the
    grid stays inside CUDA's limits."""
    for itemsize in (4, 8):
        plan = plan_mttkrp3(shape, R, mode, itemsize)
        I, J, K = shape
        assert plan.rm >= R and plan.rm % 8 == 0
        assert plan.tk in (32, 64, 128, 256)
        if mode < 2:
            n = J if mode == 0 else I
            axes = [(n, plan.ns_a, plan.per_a)]
            assert plan.ns_b == 1
            tile_rows = plan.per_a
        else:
            axes = [(I, plan.ns_a, plan.per_a), (J, plan.ns_b, plan.per_b)]
            tile_rows = plan.per_b
        for n, ns, per in axes:
            assert (ns - 1) * per < n <= ns * per
            assert 1 <= ns <= 65535
        assert tile_rows * plan.rm * itemsize <= 16384


@pytest.mark.parametrize("bad", [
    dict(shape=(2, 3, 4), R=R_MAX + 1, mode=0),
    dict(shape=(2, 3, 4), R=0, mode=0),
    dict(shape=(2, 3, 4), R=4, mode=3),
    dict(shape=(0, 3, 4), R=4, mode=1)])
def test_torch_mttkrp3_plan_rejects(bad):
    with pytest.raises(ValueError):
        plan_mttkrp3(bad["shape"], bad["R"], bad["mode"], 4)


@pytest.mark.parametrize("R", [1, R_MAX, R_MAX + 1, 40, 70, 3 * R_MAX])
def test_torch_mttkrp3_column_blocks(R):
    """mttkrp3 past R_MAX: the column blocks tile [0, R) in order, each
    within one launch's plan, and the blocks' MTTKRPs side by side equal
    the JAX package's at rank R."""
    blocks = column_blocks(R)
    assert blocks[0][0] == 0 and blocks[-1][1] == R
    assert all(a < b <= a + R_MAX for a, b in blocks)
    assert all(b == a2 for (_, b), (a2, _) in zip(blocks, blocks[1:]))
    assert len(blocks) == -(-R // R_MAX)
    for a, b in blocks:
        plan_mttkrp3((6, 5, 7), b - a, 1, 4)
    rng = np.random.default_rng(R)
    shape = (6, 5, 7)
    X = rng.standard_normal(shape)
    facs = _factors(rng, shape, R)
    for mode in range(3):
        got = torch.cat([mttkrp3_reference(
            torch.tensor(X), [torch.tensor(f[:, a:b]) for f in facs], mode)
            for a, b in blocks], dim=1)
        want = np.asarray(jt.mttkrp(jnp.asarray(X),
                                    [jnp.asarray(f) for f in facs], mode))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)


def test_torch_khatri_rao_ktensor_gram_match_jax():
    rng = np.random.default_rng(2)
    facs = _factors(rng, (4, 5, 3), 2)
    jf = [jnp.asarray(f) for f in facs]
    tf = [torch.tensor(f) for f in facs]
    w = rng.uniform(size=2)
    np.testing.assert_allclose(tt.khatri_rao(tf).numpy(),
                               np.asarray(jt.khatri_rao(jf)), rtol=1e-14)
    np.testing.assert_allclose(
        tt.ktensor_full(tf, torch.tensor(w)).numpy(),
        np.asarray(jt.ktensor_full(jf, jnp.asarray(w))), rtol=1e-12,
        atol=1e-14)
    np.testing.assert_allclose(tt.gram(tf[1]).numpy(),
                               np.asarray(jt.gram(jf[1])), rtol=1e-14)
    np.testing.assert_allclose(
        tt.hadamard_grams([tt.gram(f) for f in tf]).numpy(),
        np.asarray(jt.hadamard_grams([jt.gram(f) for f in jf])), rtol=1e-13)
    X = rng.standard_normal((4, 5, 3))
    np.testing.assert_allclose(tt.unfold(torch.tensor(X), 1).numpy(),
                               np.asarray(jt.unfold(jnp.asarray(X), 1)))


def test_torch_cp_frob_objective_matches_jax():
    rng = np.random.default_rng(3)
    facs = _factors(rng, (6, 5, 4), 2)
    X = rng.standard_normal((6, 5, 4))
    mask = rng.uniform(size=X.shape) > 0.3
    z = float(np.sum(X * X))
    want = jt.cp_frob_objective(jnp.asarray(X), [jnp.asarray(f) for f in facs],
                                jnp.asarray(z), 0.5)
    got = tt.cp_frob_objective(torch.tensor(X), [torch.tensor(f) for f in facs],
                               torch.tensor(z, dtype=torch.float64), 0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    np.testing.assert_allclose(
        float(tt.masked_frob_norm_sq(torch.tensor(X), torch.tensor(mask))),
        float(jt.masked_frob_norm_sq(jnp.asarray(X), jnp.asarray(mask))),
        rtol=1e-13)
