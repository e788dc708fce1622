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
    ENVELOPE_COPY, KERNEL_DTYPES, PLAIN_COPY, R_MAX, SMEM_MAX, STREAM_STAGES,
    STREAM_THREADS, RowsStreamPlan, StreamPlan, acc_size, column_blocks, kernel_operands,
    mttkrp3, mttkrp3_reference, plan_mttkrp3)


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


SMS = 132   # streaming multiprocessors of an H100 SXM
FLAGSHIP = (((128, 512, 256), 16), ((128, 1024, 64), 20))


def _want_copy(K, tk, itemsize, x_align):
    """The copy route of X a plan must take: bulk copies (0) where every row
    and k tile starts on 16 bytes, else the widest cp.async the alignment
    allows, else (a 16-bit X on 2 bytes) plain loads and stores."""
    want = next((w for w in (16, 8, 4) if w >= itemsize
                 and (K * itemsize) % w == 0 and (tk * itemsize) % w == 0
                 and x_align % w == 0), PLAIN_COPY)
    assert want != PLAIN_COPY or itemsize == 2
    return 0 if want == 16 else want


def _check_rows_plan(plan, shape, R, mode, itemsize, x_align, sms=SMS):
    """The rows-stream plan (modes 0/1): o tiles, walked ranges and units
    cover their axes once, k tiles cover K, KPT x RM fits 64 registers,
    the ring, F rows, C tile and warp sums fit 227 KB, the copy route
    follows the alignment: bulk copies where every row starts on 16 bytes,
    else with one k tile a bulk copy of each run's 16-byte-aligned
    envelope, else cp.async or plain copies."""
    I, J, K = shape
    O, Sn = (I, J) if mode == 0 else (J, I)
    ts = acc_size(itemsize)
    assert isinstance(plan, RowsStreamPlan) and plan.mode == mode
    assert plan.rm >= R and plan.rm % 8 == 0
    assert plan.stages == STREAM_STAGES
    # o tiles, walked ranges and the units the blocks walk
    assert 1 <= plan.ob <= O and plan.ob * plan.kthreads <= STREAM_THREADS
    n_ot = -(-O // plan.ob)
    assert (plan.ns - 1) * plan.per < Sn <= plan.ns * plan.per
    units = plan.ns * n_ot
    assert plan.nblk == min(units, sms // plan.ktiles)
    assert plan.ns == 1 or n_ot * plan.ktiles * plan.ns <= sms
    # k tiles, and the threads that own them
    assert (plan.ktiles - 1) * plan.tk < K <= plan.ktiles * plan.tk
    assert plan.ktiles == 1 or plan.tk == STREAM_THREADS * plan.kpt
    kth = plan.kthreads
    assert kth & (kth - 1) == 0 and kth // 2 < -(-plan.tk // plan.kpt) <= kth
    assert plan.threads % 32 == 0 and plan.threads <= STREAM_THREADS
    assert K % plan.kpt == 0 and plan.kpt * itemsize <= 16
    assert plan.kpt * plan.rm * ts <= 256       # 64 registers
    # stages of at most 32 KB of X and 8 KB of F rows, within a range
    assert 1 <= plan.stage_rows <= plan.per
    assert plan.stage_rows == 1 or (
        plan.ob * plan.stage_rows * plan.tk * itemsize <= 32768
        and plan.stage_rows * plan.rm * ts <= 8192)
    # the ring of X (mode 0: each o's run padded by 16 bytes; envelopes:
    # each run on 16 bytes and 16 bytes more), the ring of F rows, the C
    # tile, a sum a consumer warp, two mbarriers a slot
    want = _want_copy(K, plan.tk, itemsize, x_align)
    assert plan.copy == (ENVELOPE_COPY if want != 0 and plan.ktiles == 1
                         else want)
    if plan.copy == ENVELOPE_COPY:
        run = (plan.stage_rows if mode == 0 else plan.ob) * plan.tk * itemsize
        run = -(-run // 16) * 16 + 16
        xslot = (plan.ob * (run + 16) if mode == 0 else plan.stage_rows * run)
    else:
        xslot = plan.stage_rows * plan.ob * plan.tk * itemsize
        if mode == 0:
            xslot += plan.ob * 16
    need = (STREAM_STAGES * (xslot + plan.stage_rows * plan.rm * ts)
            + plan.tk * plan.rm * ts + plan.threads // 32 * plan.rm * ts
            + 16 * STREAM_STAGES)
    assert need <= plan.smem <= SMEM_MAX
    # F rows: one bulk copy a stage only where they are not padded
    fw = next(w for w in (16, 8, 4) if w >= ts and (R * ts) % w == 0)
    assert plan.fcopy == (0 if fw == 16 and R == plan.rm else fw)


PLAN_SHAPES = [
    ((128, 512, 256), 16), ((128, 1024, 64), 20), ((37, 50, 29), 7),
    ((5, 3, 130), 1), ((1, 1, 1), 32), ((3, 70000, 2), 9)]


def mttkrp3_plan_covers_every_row(shape, R, mode):
    """The launch plans of csrc/mttkrp3.cu, for X of 2, 4 and 8 bytes at
    each alignment of X's pointer.  Modes 0/1 (the rows-stream kernel):
    _check_rows_plan, and at the flagship shapes at least half the SMs
    busy and split partials under 1 % of X's bytes.  Mode 2 (the stream
    kernel): the row ranges cover the I*J rows once, the k tiles cover K,
    the ring and the KR tiles fit 227 KB, the copy width follows the
    alignment, and at the flagship shapes the split partials move under
    10 % of X's bytes."""
    I, J, K = shape
    for itemsize in (2, 4, 8):
        ts = acc_size(itemsize)
        for x_align in (16, 8, 4, 2):
            if x_align < itemsize:
                continue
            plan = plan_mttkrp3(shape, R, mode, itemsize, SMS, x_align=x_align)
            if mode < 2:
                _check_rows_plan(plan, shape, R, mode, itemsize, x_align)
                if (shape, R) in FLAGSHIP:
                    assert plan.nblk * plan.ktiles >= SMS // 2
                    assert plan.partial_share(shape, R) < 0.01
                    if itemsize == 4 and x_align == 16:
                        assert plan.copy == 0 and plan.ktiles == 1
                continue
            assert isinstance(plan, StreamPlan)
            assert plan.rm >= R and plan.rm % 8 == 0
            assert plan.stages == STREAM_STAGES
            # row ranges: consecutive stages, none empty, covering I*J once
            stages = -(-I * J // plan.stage_rows)
            assert (plan.nsplit - 1) * plan.spb < stages <= plan.nsplit * plan.spb
            assert plan.nsplit * plan.ktiles <= SMS
            # k tiles, and the threads that own them
            assert (plan.ktiles - 1) * plan.tk < K <= plan.ktiles * plan.tk
            assert plan.ktiles == 1 or plan.tk == STREAM_THREADS * plan.kpt
            assert plan.kthreads % 32 == 0 and plan.kthreads * plan.kpt >= plan.tk
            assert plan.threads <= STREAM_THREADS
            assert K % plan.kpt == 0 and plan.kpt * itemsize <= 16
            assert plan.kpt * plan.rm * ts <= 256      # 64 registers
            # the rings of X and of A/B rows, the consumer warps' KR rows
            # (or the phase sums that reuse them) and two mbarriers a slot
            # fit 227 KB
            ring = STREAM_STAGES * plan.stage_rows * plan.tk * itemsize
            kr = plan.stage_rows * plan.rm * ts
            warps_kr = (plan.threads // 32 * -(-plan.stage_rows // plan.phases)
                        * plan.rm * ts)
            assert plan.stage_rows * plan.tk * itemsize <= 32768 \
                or plan.stage_rows == 1
            assert kr <= 8192 or plan.stage_rows == 1
            assert plan.smem >= ring + STREAM_STAGES * (2 * kr + plan.rm * ts) \
                + warps_kr + 16 * STREAM_STAGES
            assert plan.smem >= (plan.phases * R * (plan.tk + 16 // ts) * ts
                                 + 16 * STREAM_STAGES)
            assert plan.smem <= SMEM_MAX
            assert plan.copy == _want_copy(K, plan.tk, itemsize, x_align)
            abw = next(w for w in (16, 8, 4) if w >= ts and (R * ts) % w == 0)
            assert plan.abw == (0 if abw == 16 else abw)
            if (shape, R) in FLAGSHIP:
                assert plan.nsplit * plan.ktiles >= SMS // 2
                assert plan.partial_share(shape, R) < 0.10
                if itemsize == 4 and x_align == 16:
                    assert plan.copy == 0 and plan.ktiles == 1


def _rows_walk(X, factors, plan):
    """out = the mode-`plan.mode` MTTKRP gathered as csrc/mttkrp3.cu's
    rows-stream kernel gathers it: block (b, t) walks units b, b + nblk,
    ... of k tile t, each unit its stages of walked rows, adding X[o, s, k] * F[s, :] for the tile's
    o and the k tile's k; at a unit's end it multiplies by C[k, :], sums
    over k and writes partial (range, k tile); warp w of reduce_splits
    adds partials w, w + 8, ... and the eight warp sums are added in warp
    order.  Also returns how often each (o, s, k) term was taken."""
    mode = plan.mode
    F, C = factors[1 - mode], factors[2]
    Xo = X if mode == 0 else X.transpose(0, 1)      # (o, s, k)
    O, Sn, K = Xo.shape
    R = F.shape[1]
    n_ot = -(-O // plan.ob)
    units = plan.ns * n_ot
    part = torch.zeros((plan.nsplit, O, R), dtype=X.dtype)
    seen = torch.zeros((O, Sn, K), dtype=torch.int64)
    for t in range(plan.ktiles):
        k0, k1 = t * plan.tk, min(K, (t + 1) * plan.tk)
        for b in range(plan.nblk):
            for u in range(b, units, plan.nblk):
                q, o0 = u // n_ot, u % n_ot * plan.ob
                o1 = min(O, o0 + plan.ob)
                s_end = min(Sn, (q + 1) * plan.per)
                acc = torch.zeros((o1 - o0, k1 - k0, R), dtype=X.dtype)
                for s0 in range(q * plan.per, s_end, plan.stage_rows):
                    for s in range(s0, min(s_end, s0 + plan.stage_rows)):
                        acc += Xo[o0:o1, s, k0:k1, None] * F[s]
                        seen[o0:o1, s, k0:k1] += 1
                part[q * plan.ktiles + t, o0:o1] = (acc * C[k0:k1]).sum(1)
    if plan.nsplit == 1:
        return part[0], seen
    warps = []
    for w in range(8):
        v = torch.zeros((O, R), dtype=X.dtype)
        for p in range(w, plan.nsplit, 8):
            v = v + part[p]
        warps.append(v)
    out = warps[0]
    for v in warps[1:]:
        out = out + v
    return out, seen


ROWS_WALK_CASES = [
    ((40, 30, 1), 5, SMS),       # K = 1: one thread along k
    ((37, 50, 29), 7, SMS),      # K = 29, ragged tiles and ranges
    ((7, 9, 31), 20, SMS),       # odd K
    ((1, 50, 64), 16, SMS),      # I = 1
    ((30, 3, 64), 16, SMS),      # J < ob
    ((9, 21, 64), 20, SMS),      # J not a multiple of ob
    ((20, 33, 70), 16, 4),       # fewer SMs than units: several a block
    ((4, 6, 300), 32, SMS)]      # float64 at R 32 tiles k


def mttkrp3_rows_walk_matches_jax(shape, R, sms, mode):
    """A coverage check of the rows-stream plan: its o tiles, walked
    ranges, units, stages and k tiles, walked as the kernel walks them in
    float64 on the CPU, take every (o, s, k) term exactly once, so the sum
    equals the JAX package's MTTKRP to 1e-12 (the order of the sums does
    not show at that tolerance)."""
    rng = np.random.default_rng(sum(shape) + R + mode)
    X = rng.standard_normal(shape)
    facs = _factors(rng, shape, R)
    plan = plan_mttkrp3(shape, R, mode, 8, sms)
    _check_rows_plan(plan, shape, R, mode, 8, 16, sms)
    if sms == 4:   # more units than blocks: a block walks several
        assert plan.nblk < plan.ns * -(-shape[mode] // plan.ob)
    if shape == (4, 6, 300):
        assert plan.ktiles > 1
    got, seen = _rows_walk(torch.tensor(X), [torch.tensor(f) for f in facs],
                           plan)
    assert torch.all(seen == 1)
    want = np.asarray(jt.mttkrp(jnp.asarray(X), [jnp.asarray(f) for f in facs],
                                mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _stream_walk(X, A, B, plan):
    """out = X^T KR gathered as csrc/mttkrp3.cu's stream kernel gathers it: each
    (row range, k tile) block walks its stages, thread phase p taking rows
    p, p + phases, ... of every stage; the block adds its phases in order;
    warp w of reduce_splits adds partials w, w + 8, ... and the eight
    warp sums are added in warp order."""
    I, J, K = X.shape
    R = A.shape[1]
    Xm = X.reshape(I * J, K)
    kr = (A[:, None, :] * B[None, :, :]).reshape(I * J, R)
    part = torch.zeros((plan.nsplit, K, R), dtype=X.dtype)
    rows = plan.spb * plan.stage_rows
    for b in range(plan.nsplit):
        s0, s1 = b * rows, min(I * J, (b + 1) * rows)
        for t in range(plan.ktiles):
            k0, k1 = t * plan.tk, min(K, (t + 1) * plan.tk)
            acc = torch.zeros((plan.phases, k1 - k0, R), dtype=X.dtype)
            for r0 in range(s0, s1, plan.stage_rows):
                nr = min(plan.stage_rows, s1 - r0)
                for row in range(nr):
                    s = r0 + row
                    acc[row % plan.phases] += Xm[s, k0:k1, None] * kr[s]
            tot = acc[0]
            for ph in range(1, plan.phases):
                tot = tot + acc[ph]
            part[b, k0:k1] = tot
    if plan.nsplit == 1:
        return part[0]
    warps = []
    for w in range(8):
        v = torch.zeros((K, R), dtype=X.dtype)
        for b in range(w, plan.nsplit, 8):
            v = v + part[b]
        warps.append(v)
    out = warps[0]
    for v in warps[1:]:
        out = out + v
    return out


@pytest.mark.parametrize("shape,R,sms", [
    ((37, 50, 29), 7, SMS), ((37, 50, 29), 7, 19), ((4, 33, 64), 20, 5),
    ((3, 20, 256), 16, 4), ((2, 30, 600), 32, 4)])
def test_torch_mttkrp3_stream_walk_matches_jax(shape, R, sms):
    """A coverage check of the stream plan: its row ranges, k tiles, stages
    and phases, walked as the kernel walks them in float64 on the CPU, take
    every (row, k) term exactly once, so the sum equals the JAX package's
    mode-2 MTTKRP to 1e-12 (a term dropped or taken twice would show; the
    order of the sums does not at that tolerance).  Ranges and stages start
    mid-i where their rows are not a multiple of J."""
    rng = np.random.default_rng(sum(shape) + R)
    X = rng.standard_normal(shape)
    facs = _factors(rng, shape, R)
    plan = plan_mttkrp3(shape, R, 2, 8, sms)
    assert plan.nsplit > 1 or shape == (2, 30, 600)
    got = _stream_walk(torch.tensor(X), torch.tensor(facs[0]),
                       torch.tensor(facs[1]), plan)
    want = np.asarray(jt.mttkrp(jnp.asarray(X), [jnp.asarray(f) for f in facs],
                                2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
def test_torch_mttkrp_kernel_dtype_decision(dtype):
    """tensor.mttkrp decides from X alone which path runs: every 3-way CUDA
    X launches the kernel, which takes the four float dtypes; any other
    order and any CPU X take torch.einsum.  (No CUDA tensor exists here, so
    the decision is read off takes_kernel with stand-ins.)"""
    class Stand:   # what takes_kernel reads of a tensor
        def __init__(self, ndim, device):
            self.ndim, self.device, self.dtype = ndim, torch.device(device), dtype

        def dim(self):
            return self.ndim

    assert dtype in KERNEL_DTYPES
    assert tt.takes_kernel(Stand(3, "cuda")) is True
    assert tt.takes_kernel(Stand(2, "cuda")) is False
    assert tt.takes_kernel(Stand(4, "cuda")) is False
    assert tt.takes_kernel(Stand(3, "cpu")) is False
    # the CPU path is the einsum, whatever the dtype
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.standard_normal((3, 4, 5))).to(dtype)
    facs = [torch.tensor(f).to(dtype) for f in _factors(rng, (3, 4, 5), 2)]
    before = mttkrp3.launches
    got = tt.mttkrp(X, facs, 2)
    assert mttkrp3.launches == before and got.dtype == dtype
    torch.testing.assert_close(
        got, torch.einsum("abc,az,bz->cz", X, facs[0], facs[1]))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64, torch.int32,
                                   torch.complex64])
def test_torch_mttkrp3_kernel_operands(dtype):
    """What the kernel takes (kernel_operands, which mttkrp3 runs on a CUDA
    X before any launch): X in one of the four float dtypes, the factors in
    X's dtype or promote(X.dtype, float32), handed to the kernel in the
    latter (a 16-bit factor is widened; X is never copied).  Any other
    dtype of X raises."""
    rng = np.random.default_rng(6)
    shape = (3, 4, 5)
    X = torch.tensor(rng.standard_normal(shape)).to(dtype)
    facs = [torch.tensor(f).to(dtype) for f in _factors(rng, shape, 2)]
    if dtype not in KERNEL_DTYPES:
        with pytest.raises(ValueError, match="float16, bfloat16"):
            kernel_operands(X, facs, 1)
        return
    acc = torch.promote_types(dtype, torch.float32)
    for given in {dtype, acc}:
        ops, R = kernel_operands(X, [f.to(given) for f in facs], 1)
        assert R == 2
        assert [f.dtype for n, f in enumerate(ops) if n != 1] == [acc, acc]
        for n in (0, 2):
            torch.testing.assert_close(ops[n], facs[n].to(acc), rtol=0, atol=0)
    if dtype != torch.float64:
        with pytest.raises(ValueError, match="factor 0"):
            kernel_operands(X, [facs[0].double(), facs[1], facs[2]], 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_operands(X.transpose(0, 1), [facs[1], facs[0], facs[2]], 0)


@pytest.mark.parametrize("bad", [
    dict(shape=(2, 3, 4), R=R_MAX + 1, mode=0),
    dict(shape=(2, 3, 4), R=0, mode=0),
    dict(shape=(2, 3, 4), R=4, mode=3),
    dict(shape=(0, 3, 4), R=4, mode=1),
    dict(shape=(2, 3, 4), R=R_MAX + 1, mode=2)])
def test_torch_mttkrp3_plan_rejects(bad):
    with pytest.raises(ValueError):
        plan_mttkrp3(bad["shape"], bad["R"], bad["mode"], 4, SMS)


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
        plan_mttkrp3((6, 5, 7), b - a, 1, 4, SMS)
        plan_mttkrp3((6, 5, 7), b - a, 2, 4, SMS)
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
