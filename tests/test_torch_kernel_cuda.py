"""The hand-written MTTKRP kernels (csrc/mttkrp3.cu) on a CUDA card.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.ops.mttkrp_cuda import (
    ENVELOPE_COPY, PLAIN_COPY, RowsStreamPlan, StreamPlan, column_blocks, mttkrp3,
    mttkrp3_reference, plan_mttkrp3)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, R, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal(shape)
    return X, [rng.standard_normal((n, R)) for n in shape]


@pytest.mark.parametrize("shape,R", [((37, 50, 29), 7), ((5, 3, 130), 1),
                                     ((64, 96, 80), 20), ((1, 1, 1), 32),
                                     ((3, 700, 300), 16),
                                     ((37, 50, 29), 40),     # column blocks 32 + 8
                                     ((20, 33, 70), 70)])    # 32 + 32 + 6
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_mttkrp3_kernel_matches_plain(cuda_device, shape, R, mode):
    """float64 to 1e-12 and float32 to 1e-4 of the largest entry: float32
    sums of up to J*K terms in another order than the plain version.  Past
    R 32 one launch a column block."""
    X, facs = _inputs(shape, R)
    want = mttkrp3_reference(torch.tensor(X), [torch.tensor(f) for f in facs],
                             mode)
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        Xc = torch.tensor(X, dtype=dt, device=cuda_device)
        fc = [torch.tensor(f, dtype=dt, device=cuda_device) for f in facs]
        before = mttkrp3.launches
        got = mttkrp3(Xc, fc, mode)
        torch.cuda.synchronize()
        assert mttkrp3.launches == before + len(column_blocks(R))
        assert got.dtype == dt and got.shape == (shape[mode], R)
        err = (got.double().cpu() - want).abs().max().item()
        assert err <= tol * want.abs().max().item()
        assert torch.equal(mttkrp3(Xc, fc, mode), got)   # deterministic


def _check(got, want, dt):
    tol = 1e-12 if dt == torch.float64 else 1e-4
    err = (got.double().cpu() - want.double().cpu()).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("shape,R,offset", [
    ((40, 30, 1), 5, 0),       # K = 1: one-element rows, 4/8-byte copies
    ((37, 50, 29), 7, 0),      # K = 29: ragged 4-byte copies; ranges mid-i
    ((7, 9, 31), 20, 0),       # odd K: float64 rows of 8-byte copies
    ((20, 33, 70), 32, 0),     # R 32
    ((37, 50, 29), 40, 0),     # R 40: column blocks 32 + 8
    ((6, 40, 64), 16, 1),      # X one element past an aligned pointer
    ((4, 300, 520), 32, 0)])   # float64 at R 32 tiles k (K > 256)
def test_torch_mttkrp3_mode2_stream_kernel(cuda_device, shape, R, offset):
    """The mode-2 stream kernel against the plain version: float64 to 1e-12
    and float32 to 1e-4 of the largest entry, the same bits on repeat, one
    launch a column block."""
    X, facs = _inputs(shape, R, seed=6)
    want = mttkrp3_reference(torch.tensor(X), [torch.tensor(f) for f in facs], 2)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for dt in (torch.float64, torch.float32):
        base = torch.zeros(X.size + offset, dtype=dt, device=cuda_device)
        Xc = base[offset:].view(shape)
        Xc.copy_(torch.tensor(X, dtype=dt))
        fc = [torch.tensor(f, dtype=dt, device=cuda_device) for f in facs]
        plan = plan_mttkrp3(shape, min(R, 32), 2, Xc.element_size(), sms,
                            x_align=16 if offset == 0 else Xc.element_size())
        assert isinstance(plan, StreamPlan)
        if shape == (37, 50, 29):
            rows = plan.spb * plan.stage_rows
            assert plan.nsplit > 1 and rows % shape[1] != 0   # mid-i
        before = mttkrp3.launches
        got = mttkrp3(Xc, fc, 2)
        torch.cuda.synchronize()
        assert mttkrp3.launches == before + len(column_blocks(R))
        assert got.dtype == dt and got.shape == (shape[2], R)
        _check(got, want, dt)
        assert torch.equal(mttkrp3(Xc, fc, 2), got)


@pytest.mark.parametrize("shape,R,offset", [
    ((37, 50, 29), 7, 0),      # odd K: plain copies of X in mode 2
    ((37, 50, 29), 7, 1),      # ... and X on 2 bytes
    ((6, 40, 64), 16, 0),      # bulk copies
    ((6, 40, 64), 16, 2),      # 4-byte cp.async
    ((4, 300, 520), 32, 0),    # k tiles
    ((4, 300, 520), 32, 1),    # k tiles, X on 2 bytes: plain copies
    ((20, 33, 70), 40, 0)])    # column blocks 32 + 8
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_torch_mttkrp3_kernel_16bit_x(cuda_device, shape, R, offset, dtype):
    """A float16 or bfloat16 X, as the Pallas kernel takes it: widened to
    float32 on load, float32 factors and output.  Every mode against the
    float64 plain version of the same (rounded) inputs, to 1e-4 of the
    largest entry (float32 sums), the same bits on repeat."""
    X, facs = _inputs(shape, R, seed=9)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    base = torch.zeros(X.size + offset, dtype=dtype, device=cuda_device)
    Xc = base[offset:].view(shape)
    Xc.copy_(torch.tensor(X, dtype=dtype))
    fc = [torch.tensor(f, dtype=torch.float32, device=cuda_device)
          for f in facs]
    X64 = Xc.double().cpu()
    if offset == 1 and R <= 32:
        for mode in range(3):
            plan = plan_mttkrp3(shape, R, mode, 2, sms, x_align=2)
            # modes 0/1 copy whole runs' envelopes where k is not tiled
            assert plan.copy == (ENVELOPE_COPY if mode < 2 and plan.ktiles == 1
                                 else PLAIN_COPY)
    for mode in range(3):
        want = mttkrp3_reference(X64, [f.double().cpu() for f in fc], mode)
        before = mttkrp3.launches
        got = mttkrp3(Xc, fc, mode)
        torch.cuda.synchronize()
        assert mttkrp3.launches == before + len(column_blocks(R))
        assert got.dtype == torch.float32 and got.shape == (shape[mode], R)
        _check(got, want, torch.float32)
        assert torch.equal(mttkrp3(Xc, fc, mode), got)
        # 16-bit factors are widened by the wrapper: the same result
        half = [f.to(dtype) for f in fc]
        got_h = mttkrp3(Xc, half, mode)
        want_h = mttkrp3_reference(X64, [f.double().cpu() for f in half], mode)
        _check(got_h, want_h, torch.float32)


@pytest.mark.parametrize("shape,R,offset", [
    ((40, 30, 1), 5, 0),       # K = 1: one thread along k, 4/8-byte copies
    ((37, 50, 29), 7, 0),      # K = 29: ragged o tiles and walked ranges
    ((7, 9, 31), 20, 0),       # odd K: float64 rows of 8-byte copies
    ((20, 33, 70), 32, 0),     # R 32
    ((37, 50, 29), 40, 0),     # R 40: column blocks 32 + 8
    ((6, 40, 64), 16, 1),      # X one element past an aligned pointer
    ((4, 300, 520), 32, 0),    # float64 at R 32 tiles k (K > 256)
    ((2000, 40, 64), 16, 0),   # mode 0: blocks walk several o tiles
    ((40, 2000, 64), 16, 0)])  # mode 1: the same
@pytest.mark.parametrize("mode", [0, 1])
def test_torch_mttkrp3_rows_stream_kernel(cuda_device, shape, R, offset, mode):
    """The modes-0/1 stream kernel against the plain version: float64 to
    1e-12 and float32 to 1e-4 of the largest entry, the same bits on
    repeat, one launch a column block."""
    X, facs = _inputs(shape, R, seed=6)
    want = mttkrp3_reference(torch.tensor(X), [torch.tensor(f) for f in facs],
                             mode)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for dt in (torch.float64, torch.float32):
        base = torch.zeros(X.size + offset, dtype=dt, device=cuda_device)
        Xc = base[offset:].view(shape)
        Xc.copy_(torch.tensor(X, dtype=dt))
        fc = [torch.tensor(f, dtype=dt, device=cuda_device) for f in facs]
        plan = plan_mttkrp3(shape, min(R, 32), mode, Xc.element_size(), sms,
                            x_align=16 if offset == 0 else Xc.element_size())
        assert isinstance(plan, RowsStreamPlan)
        assert (plan.copy == 0) == (
            offset == 0 and shape[2] * Xc.element_size() % 16 == 0)
        if shape[mode] == 2000:   # more units than blocks
            assert plan.nblk < plan.ns * -(-shape[mode] // plan.ob)
        if shape == (4, 300, 520) and dt == torch.float64:
            assert plan.ktiles > 1
        before = mttkrp3.launches
        got = mttkrp3(Xc, fc, mode)
        torch.cuda.synchronize()
        assert mttkrp3.launches == before + len(column_blocks(R))
        assert got.dtype == dt and got.shape == (shape[mode], R)
        _check(got, want, dt)
        assert torch.equal(mttkrp3(Xc, fc, mode), got)


def test_torch_fit_on_cuda_takes_a_permuted_x(cuda_device):
    """A dense CP fit on the card from a permuted (non-contiguous) view of X
    matches the same fit on contiguous data: fit copies X once.  A float16
    CUDA X launches the kernel through tensor.mttkrp, which returns the
    einsum's dtype (float16 here)."""
    import matlab_code_tpu_torch as tp
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.ops import tensor as tt

    rng = np.random.default_rng(8)
    X = rng.standard_normal((10, 12, 14))
    Xc = torch.tensor(X, device=cuda_device)
    Xp = torch.tensor(X.transpose(2, 0, 1).copy(),
                      device=cuda_device).permute(1, 2, 0)
    assert not Xp.is_contiguous() and torch.equal(Xp, Xc)
    spec = tp.ProblemSpec(
        mode_sizes=(10, 12, 14),
        datasets=(tp.DatasetSpec(model="CP", modes=(0, 1, 2), rank=3),),
        coupling=tp.CouplingSpec(lin_coupled_modes=(0, 0, 0),
                                 coupling_type=()),
        constraints=(tp.ConstraintSpec("non-negativity"), None, None))
    init = tp.InitOptions(distr=("rand",) * 3, normalize=True,
                          lambdas_init=((1,) * 3,))
    data_cpu = tp.ProblemData(objects=(torch.tensor(X),),
                              coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    state0 = state_to_numpy(init_coupled(spec, data_cpu, init, seed=4))
    opts = tp.AlgOptions(MaxOuterIters=3, AbsFuncTol=0.0, OuterRelTol=0.0)
    outs = []
    for Xd in (Xc, Xp):
        data = tp.ProblemData(objects=(Xd,), coupl_trafo=(None,) * 3,
                              coupl_trafo2=(None,) * 3)
        before = mttkrp3.launches
        _, out = tp.fit(spec, data, state_from_numpy(state0, cuda_device,
                                                     torch.float64), opts)
        assert mttkrp3.launches - before == 1 + 3 * 3
        outs.append(out)
    np.testing.assert_array_equal(outs[1].func_val_conv, outs[0].func_val_conv)
    np.testing.assert_array_equal(outs[1].func_constr_conv,
                                  outs[0].func_constr_conv)
    Xh = torch.tensor(rng.standard_normal((4, 4, 4)), dtype=torch.float16,
                      device=cuda_device)
    fh = [torch.tensor(rng.standard_normal((4, 2)), dtype=torch.float16,
                       device=cuda_device) for _ in range(3)]
    before = mttkrp3.launches
    got = tt.mttkrp(Xh, fh, 1)
    assert mttkrp3.launches == before + 1 and got.dtype == torch.float16
    want = mttkrp3_reference(Xh.double().cpu(), [f.double().cpu() for f in fh],
                             1)
    # float32 sums, rounded to float16 once
    err = (got.double().cpu() - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item()


def test_torch_mttkrp3_kernel_rejects_what_it_does_not_take(cuda_device):
    X, facs = _inputs((4, 5, 6), 3)
    Xc = torch.tensor(X, device=cuda_device)
    fc = [torch.tensor(f, device=cuda_device) for f in facs]
    with pytest.raises(ValueError, match="contiguous"):
        mttkrp3(Xc.transpose(0, 1), [fc[1], fc[0], fc[2]], 0)
    with pytest.raises(ValueError):
        mttkrp3(Xc, [fc[0], fc[1].float(), fc[2]], 0)
    with pytest.raises(ValueError):
        mttkrp3(Xc, [fc[0], fc[1].cpu(), fc[2]], 0)
    with pytest.raises(ValueError, match="float16, bfloat16"):
        mttkrp3(Xc.int(), fc, 2)


def test_torch_fit_on_cuda_runs_the_kernel_and_matches_cpu(cuda_device):
    """A small type-4 coupled fit: float64 on the card through the kernel
    against float64 on the CPU through the plain einsum."""
    from matlab_code_tpu_torch import AlgOptions, fit
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.utils import flagship

    spec, data = flagship.build_problem("cpu", torch.float64)
    state0 = init_coupled(spec, data, flagship.flagship_init_options(), seed=3)
    opts = AlgOptions(MaxOuterIters=3, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_cpu = fit(spec, data, state0, opts)
    spec_g, data_g = flagship.build_problem(cuda_device, torch.float64)
    before = mttkrp3.launches
    _, out_gpu = fit(spec_g, data_g,
                     state_from_numpy(state_to_numpy(state0), cuda_device,
                                      torch.float64), opts)
    assert mttkrp3.launches - before == 2 + 6 * 3
    np.testing.assert_allclose(out_gpu.func_val_conv, out_cpu.func_val_conv,
                               rtol=1e-9)
    np.testing.assert_allclose(out_gpu.func_coupl_conv, out_cpu.func_coupl_conv,
                               rtol=1e-8)


def test_torch_cp_fit_on_cuda_past_rank_32(cuda_device):
    """A dense CP fit at rank 34 runs on the card (two column blocks a
    MTTKRP) and matches the CPU, both in float64."""
    import matlab_code_tpu_torch as tp
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.init import init_coupled

    R = 34
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.standard_normal((10, 12, 14)))
    spec = tp.ProblemSpec(
        mode_sizes=(10, 12, 14),
        datasets=(tp.DatasetSpec(model="CP", modes=(0, 1, 2), rank=R),),
        coupling=tp.CouplingSpec(lin_coupled_modes=(0, 0, 0),
                                 coupling_type=()),
        constraints=(tp.ConstraintSpec("non-negativity"), None, None))
    init = tp.InitOptions(distr=("rand",) * 3, normalize=True,
                          lambdas_init=((1,) * R,))
    data = tp.ProblemData(objects=(X,), coupl_trafo=(None,) * 3,
                          coupl_trafo2=(None,) * 3)
    state0 = init_coupled(spec, data, init, seed=2)
    opts = tp.AlgOptions(MaxOuterIters=2, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_cpu = tp.fit(spec, data, state0, opts)
    data_g = tp.ProblemData(objects=(X.to(cuda_device),),
                            coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    before = mttkrp3.launches
    _, out_gpu = tp.fit(spec, data_g,
                        state_from_numpy(state_to_numpy(state0), cuda_device,
                                         torch.float64), opts)
    assert mttkrp3.launches - before == 2 * (1 + 3 * 2)
    np.testing.assert_allclose(out_gpu.func_val_conv, out_cpu.func_val_conv,
                               rtol=1e-9)
