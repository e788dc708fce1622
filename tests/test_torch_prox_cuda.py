"""The sequential-prox kernels (csrc/prox_seq.cu: kernel A, isotonic and
unimodal; kernel B, TV; csrc/t_smooth.cu: kernel C, the tPARAFAC2 prox) on
a CUDA card, on the three routes of A and B (a block a column with its
state in shared memory up to prox_cuda.plan_isotonic's / plan_tv's limit,
or in device memory past it; a thread a column, a warp 32 columns, for
stacks of many columns) and on stacks of PARAFAC2 slices (regular, ragged
in one launch, one lam a slice), and
coupled CP fits of types 1 and 5 and PARAFAC2 fits on the card against the
CPU.

Every test here needs the card and skips without one.  This file imports
no jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_prox_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.ops import isotonic, prox, prox_cuda, tv
from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
from matlab_code_tpu_torch.models.admm import prox_slicewise, prox_slicewise_ragged
from matlab_code_tpu_torch.utils import par2_surface, surface

pytestmark = pytest.mark.cuda

NS = (1, 2, 29, 256, 512, 1024, 4096)
RS = (1, 16, 20, 40)
KINDS_A = ((isotonic.INCREASING, False), (isotonic.DECREASING, False),
           (isotonic.UNIMODAL, False), (isotonic.UNIMODAL, True))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, R, seed=2):
    """Normal columns, a constant column, ties (a 0.5 grid) and an
    all-negative column."""
    rng = np.random.default_rng(seed + 13 * n + R)
    X = rng.standard_normal((n, R))
    if R >= 4:
        X[:, 1] = -0.7
        X[:, 2] = np.round(2 * X[:, 2]) / 2
        X[:, 3] = -np.abs(X[:, 3]) - 0.1
    return X


def _assert_close(got, want, rtol):
    """Elementwise |got - want| <= rtol |want|, against the float64 plain
    version of the same (rounded) input: the kernels walk the same
    arithmetic in float64, so float64 agrees to rounding and float32 is
    that result rounded once."""
    g, w = got.double().cpu(), want.double()
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=0)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("n", NS)
def test_torch_isotonic_kernel_matches_plain(cuda_device, n, R):
    X = _inputs(n, R)
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        for kind, nn in KINDS_A:
            want = isotonic.columns_reference(Xd.double().cpu(), kind, nn)
            before = prox_cuda.project_isotonic_cols.launches
            got = prox_cuda.project_isotonic_cols(Xd, kind, nn)
            torch.cuda.synchronize()
            assert prox_cuda.project_isotonic_cols.launches == before + 1
            assert got.dtype == dt and got.shape == (n, R)
            _assert_close(got, want, rtol)
            assert torch.equal(prox_cuda.project_isotonic_cols(Xd, kind, nn), got)
            if nn:
                assert float(got.min()) >= 0


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("n", NS)
def test_torch_tv_kernel_matches_plain(cuda_device, n, R):
    """lam = 0 (the column itself), a small lam, and lam above every
    column's total variation (the column means), as a number and as a 0-d
    card tensor."""
    X = _inputs(n, R)
    tv_max = float(np.abs(np.diff(X, axis=0)).sum(axis=0).max()) if n > 1 else 0
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        for lam in (0.0, 0.05, tv_max + 1.0):
            want = tv.columns_reference(Xd.double().cpu(), lam)
            before = prox_cuda.prox_tv_cols.launches
            got = prox_cuda.prox_tv_cols(Xd, lam)
            got_t = prox_cuda.prox_tv_cols(
                Xd, torch.tensor(lam, dtype=torch.float64, device=cuda_device))
            torch.cuda.synchronize()
            assert prox_cuda.prox_tv_cols.launches == before + 2
            assert got.dtype == dt and torch.equal(got, got_t)
            _assert_close(got, want, rtol)


def test_torch_long_columns_take_the_global_route(cuda_device):
    """Columns past the shared route's limit (kernel A at n = 8192, kernel
    B at n = 20480) take the global route, held to the plain version."""
    A, B = prox_cuda.project_isotonic_cols, prox_cuda.prox_tv_cols
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(_inputs(8192, 3), dtype=dt, device=cuda_device)
        assert prox_cuda.plan_isotonic(8192, 3, dt)[0] == "global"
        for kind, nn in KINDS_A:
            before = dict(A.route_launches)
            got = A(Xd, kind, nn)
            torch.cuda.synchronize()
            assert A.route_launches == {**before, "global": before["global"] + 1}
            _assert_close(got, isotonic.columns_reference(Xd.double().cpu(),
                                                          kind, nn), rtol)
        Xd = torch.tensor(_inputs(20480, 2), dtype=dt, device=cuda_device)
        assert prox_cuda.plan_tv(20480, 2, dt)[0] == "global"
        before = dict(B.route_launches)
        got = B(Xd, 0.05)
        torch.cuda.synchronize()
        assert B.route_launches == {**before, "global": before["global"] + 1}
        _assert_close(got, tv.columns_reference(Xd.double().cpu(), 0.05), rtol)


@pytest.mark.parametrize("n,R", [(29, 5), (512, 16), (4096, 3)])
def test_torch_both_routes_give_the_same_bits(cuda_device, n, R):
    """The shared route (planned) and the global route (named through the
    private launchers) run the same kernel bodies, their state in shared
    or in device memory: the same bits, every kind.  The shared route
    named past its limit is refused by the card, and raises."""
    A, B = prox_cuda.project_isotonic_cols, prox_cuda.prox_tv_cols
    for dt in (torch.float64, torch.float32):
        Xd = torch.tensor(_inputs(n, R, seed=8), dtype=dt, device=cuda_device)
        for kind, nn in KINDS_A:
            shared = A.route_launches["shared"]
            got = A(Xd, kind, nn)
            assert A.route_launches["shared"] == shared + 1
            assert torch.equal(got, prox_cuda._isotonic(Xd, kind, nn, "global"))
        for lam in (0.0, 0.02, 0.5):
            shared = B.route_launches["shared"]
            got = B(Xd, lam)
            assert B.route_launches["shared"] == shared + 1
            assert torch.equal(got, prox_cuda._tv(Xd, lam, "global"))
    with pytest.raises(RuntimeError, match="shared route"):
        prox_cuda._isotonic(torch.zeros(8192, 1, device=cuda_device), 0, False,
                            "shared")
    # the refusal is not left behind for the next launch to report
    assert torch.equal(A(Xd, 0), prox_cuda._isotonic(Xd, 0, False, "global"))


def test_torch_kernels_match_plain_on_nonfinite_columns(cuda_device):
    """NaN and +-1e200 (whose square is inf) in a column: both routes
    follow the plain walk (the unimodal peak at the first NaN of the
    summed errors, or among infinite errors).  Kernel A on columns holding
    -inf or +inf, which would merge past slot 0 without its NaN sentinel,
    ends and follows the plain walk."""
    X = _inputs(40, 5, seed=4)
    X[10, 0], X[3, 1], X[30, 2], X[0, 4] = np.nan, -1e200, 1e200, np.nan
    Xd = torch.tensor(X, device=cuda_device)
    Y = _inputs(40, 4, seed=5)
    Y[0, 0], Y[7, 1], Y[8, 1], Y[39, 2] = -np.inf, -np.inf, -np.inf, -np.inf
    Y[5, 3], Y[0, 2] = np.inf, np.inf
    Yd = torch.tensor(Y, device=cuda_device)
    for route in ("shared", "global", "lanes"):
        for M in (Xd, Yd):
            for kind, nn in KINDS_A:
                got = prox_cuda._isotonic(M, kind, nn, route)
                _assert_close(got, isotonic.columns_reference(M.cpu(), kind, nn),
                              1e-12)
        got = prox_cuda._tv(Xd, 0.1, route)
        _assert_close(got, tv.columns_reference(Xd.cpu(), 0.1), 1e-12)


def test_torch_sequential_proxes_dispatch_to_the_kernels(cuda_device):
    """make_prox's monotone, unimodal and TV proxes launch the kernels on a
    card tensor (a view that is not contiguous too), with rho a card
    tensor; a dtype the kernels do not take raises."""
    X = torch.tensor(_inputs(30, 6), device=cuda_device)
    rho = torch.tensor(0.5, dtype=torch.float64, device=cuda_device)
    for kind, params, n_a, n_b in (("non-decreasing", (), 1, 0),
                                   ("non-increasing", (), 1, 0),
                                   ("unimodality", (1,), 1, 0),
                                   ("TV regularization", (0.1,), 0, 1)):
        p, _ = prox.make_prox(prox.ConstraintSpec(kind, params), 30)
        a, b = (prox_cuda.project_isotonic_cols.launches,
                prox_cuda.prox_tv_cols.launches)
        got = p(X.T.contiguous().T, rho)
        assert (prox_cuda.project_isotonic_cols.launches - a,
                prox_cuda.prox_tv_cols.launches - b) == (n_a, n_b)
        _assert_close(got, p(X.cpu(), 0.5), 1e-12)
    with pytest.raises(ValueError, match="float32 or float64"):
        prox_cuda.prox_tv_cols(X.half(), 0.1)


@pytest.mark.parametrize("ctype", [1, 5])
def test_torch_coupled_fit_on_cuda_matches_cpu(cuda_device, ctype):
    """The surface workload (mode sizes / 4) of coupling type 1 or 5 on the
    card and on the CPU in float64 from one init state, 3 outer
    iterations: the four streams at rtol 1e-8, with the dense MTTKRP and
    both sequential-prox kernels launched."""
    spec, data_c, ds = surface.build_problem(ctype, "cpu", torch.float64,
                                             scale=4)
    state0 = state_to_numpy(init_coupled(
        spec, data_c, surface.surface_init_options(ctype), seed=1,
        delta_shapes=ds))
    opts = surface.surface_options(3, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_cpu = tp.fit(spec, data_c, state_from_numpy(state0, "cpu"), opts)
    _, data_d, _ = surface.build_problem(ctype, cuda_device, torch.float64,
                                         scale=4)
    before = (mttkrp3.launches,
              prox_cuda.project_isotonic_cols.launches,
              prox_cuda.prox_tv_cols.launches)
    _, out = tp.fit(spec, data_d, state_from_numpy(state0, cuda_device), opts)
    after = (mttkrp3.launches,
             prox_cuda.project_isotonic_cols.launches,
             prox_cuda.prox_tv_cols.launches)
    assert [a - b for a, b in zip(after, before)][0] >= 6 * 3
    assert all(a > b for a, b in zip(after, before))
    for a, b in [(out.func_val_conv, out_cpu.func_val_conv),
                 (out.func_coupl_conv, out_cpu.func_coupl_conv),
                 (out.func_constr_conv, out_cpu.func_constr_conv)]:
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0)


def _stack(K, n, R, seed=4):
    """A (K, n, R) stack of _inputs slices, each slice its own draw."""
    return np.stack([_inputs(n, R, seed + k) for k in range(K)])


@pytest.mark.parametrize("K,n,R", [(1, 29, 5), (2, 256, 32), (3, 40, 7),
                                   (64, 256, 32)])
def test_torch_batched_isotonic_kernel_matches_plain(cuda_device, K, n, R):
    """Kernel A on a (K, n, R) stack, one launch for the K R columns, against
    the plain walk of every column."""
    X = _stack(K, n, R)
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        for kind, nn in KINDS_A:
            want = isotonic.columns_reference(Xd.double().cpu(), kind, nn)
            before = prox_cuda.project_isotonic_cols.launches
            got = prox_cuda.project_isotonic_cols(Xd, kind, nn)
            torch.cuda.synchronize()
            assert prox_cuda.project_isotonic_cols.launches == before + 1
            assert got.shape == (K, n, R) and got.dtype == dt
            _assert_close(got, want, rtol)
            if dt == torch.float64:
                assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("K,n,R", [(1, 29, 5), (2, 256, 32), (3, 40, 7),
                                   (64, 256, 32)])
def test_torch_batched_tv_kernel_matches_plain(cuda_device, K, n, R):
    """Kernel B on a (K, n, R) stack with one lam a slice (0 for the first
    slice, above every column's TV for the last), read on the card."""
    X = _stack(K, n, R)
    lam = np.linspace(0.0, 0.3, K)
    if K > 1:
        lam[-1] = 1.0 + float(np.max(np.sum(np.abs(np.diff(X, axis=1)),
                                            axis=1)))
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        lam_d = torch.tensor(lam, device=cuda_device)
        want = tv.columns_reference(Xd.double().cpu(), torch.tensor(lam))
        before = prox_cuda.prox_tv_cols.launches
        got = prox_cuda.prox_tv_cols(Xd, lam_d)
        torch.cuda.synchronize()
        assert prox_cuda.prox_tv_cols.launches == before + 1
        _assert_close(got, want, rtol)
        assert torch.equal(got[0], Xd[0])
        if dt == torch.float64:
            assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="lam values"):
        prox_cuda.prox_tv_cols(Xd, lam_d[:1].expand(K + 1))


def test_torch_slicewise_prox_on_the_card_matches_cpu(cuda_device):
    """prox_slicewise and prox_slicewise_ragged (padded rows exactly zero)
    with unimodal and TV proxes and one rho a slice, one launch each, card
    against CPU in float64: the ragged stack takes the lanes route and
    gives the bits of the CPU's size buckets."""
    rng = np.random.default_rng(3)
    sizes = (30, 24, 30, 17, 24, 30)
    X = rng.standard_normal((6, 30, 4))
    rho = torch.tensor(rng.uniform(0.5, 2.0, 6))
    for kind, params, counter in (
            ("unimodality", (True,), prox_cuda.project_isotonic_cols),
            ("TV regularization", (0.05,), prox_cuda.prox_tv_cols)):
        p, _ = prox.make_prox(prox.ConstraintSpec(kind, params), 30)
        before = counter.launches
        got = prox_slicewise(p, torch.tensor(X, device=cuda_device),
                             rho.to(cuda_device))
        assert counter.launches == before + 1
        _assert_close(got, prox_slicewise(p, torch.tensor(X), rho), 1e-12)
        before = counter.launches
        lanes = counter.route_launches["lanes"]
        got = prox_slicewise_ragged(p, torch.tensor(X, device=cuda_device),
                                    rho.to(cuda_device), sizes)
        assert counter.launches == before + 1
        assert counter.route_launches["lanes"] == lanes + 1
        want = prox_slicewise_ragged(p, torch.tensor(X), rho, sizes)
        assert torch.equal(got.cpu(), want)
        for k, J in enumerate(sizes):
            assert not bool(got[k, J:].any())


LANE_SHAPES = [(512, 256, 32), (1, 256, 32), (3, 256, 32), (2, 29, 5),
               (7, 29, 5), (4, 1, 9), (5, 2, 7), (2, 1900, 3)]


@pytest.mark.parametrize("K,n,R", LANE_SHAPES)
def test_torch_lanes_route_matches_plain(cuda_device, K, n, R):
    """The lanes route (a thread a column's scan side, a warp 32 adjacent
    columns, the last warp's lanes past K R idle) against the plain walk:
    every kind of kernel A and kernel B with one lam a slice; float64 the
    same bits, float32 the float64 result rounded once (rtol 1e-5).  At
    n = 1900 kernel B's columns pass a warp's shared memory and are staged
    in a device-memory workspace."""
    X = _stack(K, n, R)
    lam = np.linspace(0.0, 0.05, K)
    if K > 2:
        lam[-1] = 1.0 + float(np.max(np.sum(np.abs(np.diff(X, axis=1)),
                                            axis=1)))
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        Xh = Xd.double().cpu()
        for kind, nn in KINDS_A:
            want = isotonic.columns_reference(Xh, kind, nn)
            before = prox_cuda.project_isotonic_cols.route_launches["lanes"]
            got = prox_cuda._isotonic(Xd, kind, nn, "lanes")
            torch.cuda.synchronize()
            assert prox_cuda.project_isotonic_cols.route_launches["lanes"] \
                == before + 1
            assert got.dtype == dt and got.shape == (K, n, R)
            _assert_close(got, want, rtol)
            assert torch.equal(got.cpu(), want.to(dt))
        want = tv.columns_reference(Xh, torch.tensor(lam))
        lam_d = torch.tensor(lam, device=cuda_device)
        got = prox_cuda._tv(Xd, lam_d, "lanes")
        _assert_close(got, want, rtol)
        assert torch.equal(got.cpu(), want.to(dt))
        # the columns staged in a device-memory workspace (the variant for
        # columns past a warp's shared memory): the same bits
        assert torch.equal(prox_cuda._tv(Xd, lam_d, "lanes", in_shared=False),
                           got)


def test_torch_plan_sends_many_columns_to_the_lanes_route(cuda_device):
    """The PAR2 stack (512, 256, 32) goes to the lanes route through the
    public wrappers; a CP-shaped matrix keeps the block route."""
    X = torch.tensor(_stack(512, 256, 32), dtype=torch.float32,
                     device=cuda_device)
    A, B = prox_cuda.project_isotonic_cols, prox_cuda.prox_tv_cols
    for fn, call in ((A, lambda M: A(M, 2, True)), (B, lambda M: B(M, 1e-3))):
        before = dict(fn.route_launches)
        call(X)
        call(X[0, :, :16].contiguous())
        torch.cuda.synchronize()
        assert fn.route_launches == {**before,
                                     "lanes": before["lanes"] + 1,
                                     "shared": before["shared"] + 1}


@pytest.mark.parametrize("R", [5, 32])
def test_torch_ragged_stack_is_one_launch(cuda_device, R):
    """A padded ragged stack (J_k in 1..40, K R not a multiple of 32 at R
    = 5) in one lanes launch: each column walks its slice's J_k rows, the
    padded rows come back exactly zero, and the result has the bits of
    the plain version on each slice's true rows (float64) or that result
    rounded once (float32); a ragged stack on another route, and sizes
    out of range, raise."""
    rng = np.random.default_rng(R)
    sizes = tuple(int(J) for J in rng.integers(1, 41, 9))
    X = rng.standard_normal((9, 40, R))
    A, B = prox_cuda.project_isotonic_cols, prox_cuda.prox_tv_cols
    lam = rng.uniform(0.0, 0.2, 9)
    for dt in (torch.float64, torch.float32):
        Xd = torch.tensor(X, dtype=dt, device=cuda_device)
        Xh = Xd.double().cpu()
        for kind, nn in KINDS_A:
            want = isotonic.ragged_reference(
                Xh, sizes, lambda k, M: isotonic.columns_reference(M, kind, nn))
            before = A.route_launches["lanes"]
            got = A(Xd, kind, nn, sizes)
            torch.cuda.synchronize()
            assert A.route_launches["lanes"] == before + 1
            assert torch.equal(got.cpu(), want.to(dt))
            for k, J in enumerate(sizes):
                assert not bool(got[k, J:].any())
        want = isotonic.ragged_reference(
            Xh, sizes, lambda k, M: tv.columns_reference(M, float(lam[k])))
        before = B.route_launches["lanes"]
        got = B(Xd, torch.tensor(lam, device=cuda_device), sizes)
        assert B.route_launches["lanes"] == before + 1
        assert torch.equal(got.cpu(), want.to(dt))
    with pytest.raises(ValueError, match="lanes route"):
        prox_cuda._isotonic(Xd, 2, True, "shared", sizes)
    with pytest.raises(ValueError, match="slice lengths"):
        A(Xd, 0, False, (41,) + sizes[1:])


def _staged_limit(dt):
    """The largest K kernel C's plan stages in dtype dt."""
    K = 1
    while prox_cuda.plan_t_smooth(K + 1, 1, dt)[0] == prox_cuda.STAGED:
        K += 1
    return K


def _t_smooth_operands(K, J, R, dt, operands, rng):
    """(B, rho) as numpy arrays of dt: "normal" draws, or "wide" ones: B
    across 2^-60..2^60 with zeros, negative zeros and subnormals, rho in
    [1e-6, 1e6] (a log-uniform draw)."""
    npdt = np.float64 if dt == torch.float64 else np.float32
    if operands == "normal":
        return (rng.standard_normal((K, J, R)).astype(npdt),
                rng.uniform(0.2, 3.0, K).astype(npdt))
    B = rng.standard_normal((K, J, R)) * 2.0 ** rng.integers(-60, 61, (K, J, R))
    B = B.astype(npdt)
    u = rng.random((K, J, R))
    tiny = np.finfo(npdt).smallest_subnormal
    B[u < 0.05] = 0.0
    B[(u >= 0.05) & (u < 0.08)] = -0.0
    sub = (u >= 0.08) & (u < 0.11)
    B[sub] = (tiny * rng.integers(1, 1000, int(sub.sum()))).astype(npdt)
    return B, (10.0 ** rng.uniform(-6.0, 6.0, K)).astype(npdt)


def _same_bits(a, b):
    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.cpu().view(iv), b.cpu().view(iv))


@pytest.mark.parametrize("operands", ["normal", "wide"])
@pytest.mark.parametrize("K,J,R", [(1, 5, 3), (2, 30, 4), (3, 7, 2),
                                   (511, 9, 7), (512, 256, 32), (900, 3, 5),
                                   ("limit", 3, 5), ("past", 3, 5)])
def test_torch_t_smooth_kernel_matches_plain(cuda_device, K, J, R, operands):
    """Kernel C on both routes against its plain version (ops/prox.t_smoothness_reference): the same
    bits in float64 and in float32, on normal draws at eta 10 and on wide
    ones (B across 2^+-60 with zeros and subnormals, rho in [1e-6, 1e6])
    at eta 1e-3, 1 and 1e6, which take the back substitution's full
    division where the correction's window ends.  "limit" is the staged
    route's largest K in each dtype, "past" one more (the stream route);
    K = 900 is past the staged limit in float64 only."""
    rng = np.random.default_rng((J + R) * (2 if operands == "wide" else 1))
    etas = (10.0,) if operands == "normal" else (1e-3, 1.0, 1e6)
    for dt in (torch.float64, torch.float32):
        k = {"limit": _staged_limit(dt), "past": _staged_limit(dt) + 1}.get(K, K)
        B, rho = _t_smooth_operands(k, J, R, dt, operands, rng)
        Bd = torch.tensor(B, device=cuda_device)
        rd = torch.tensor(rho, device=cuda_device)
        route = prox_cuda.plan_t_smooth(k, J * R, dt, torch.cuda.get_device_properties(
            cuda_device).multi_processor_count)[0]
        for eta in etas:
            want = prox.t_smoothness_reference(Bd.cpu(), rd.cpu(), eta)
            before = prox_cuda.t_smooth_cols.route_launches[route]
            got = prox.t_smoothness_prox(Bd, rd, eta)
            torch.cuda.synchronize()
            assert prox_cuda.t_smooth_cols.route_launches[route] == before + 1
            assert got.dtype == dt and _same_bits(got, want), (k, dt, eta)
            stream = prox_cuda._t_smooth(Bd, rd, eta, prox_cuda.STREAM)
            assert _same_bits(stream, want), (k, dt, eta, "stream")
    with pytest.raises(ValueError, match="rho values"):
        prox_cuda.t_smooth_cols(Bd, torch.cat([rd, rd]), 1.0)


def test_torch_t_smooth_stream_route_reaches_its_limit(cuda_device):
    """The stream route at its largest K in each dtype (2 K values of
    shared memory a block: 14464 in float64, 28928 in float32) gives the
    plain version's bits; one more slice is refused before the launch."""
    rng = np.random.default_rng(7)
    for dt, K in ((torch.float64, 14464), (torch.float32, 28928)):
        assert prox_cuda.plan_t_smooth(K, 6, dt)[0] == prox_cuda.STREAM
        B = torch.tensor(rng.standard_normal((K, 3, 2)), dtype=dt,
                         device=cuda_device)
        rho = torch.tensor(rng.uniform(0.2, 3.0, K), dtype=dt,
                           device=cuda_device)
        want = prox.t_smoothness_reference(B.cpu(), rho.cpu(), 10.0)
        assert _same_bits(prox_cuda.t_smooth_cols(B, rho, 10.0), want), dt
        with pytest.raises(ValueError, match="shared memory"):
            prox_cuda.t_smooth_cols(torch.cat([B, B[:1]]),
                                    torch.cat([rho, rho[:1]]), 10.0)


def test_torch_t_smooth_phases_walk_the_recurrence(cuda_device):
    """The staged route's phases alone (the phase breakdown's entry): the
    recurrence phase writes {rho, m, d'} a slice (y_k is the walkers'),
    and the walk phase from them gives the kernel's bits; staging alone
    runs."""
    rng = np.random.default_rng(5)
    for dt in (torch.float32, torch.float64):
        B = torch.tensor(rng.standard_normal((512, 16, 32)), dtype=dt,
                         device=cuda_device)
        rho = torch.tensor(rng.uniform(0.5, 1.5, 512), dtype=dt,
                           device=cuda_device)
        dbg = torch.zeros(4 * 512, dtype=dt, device=cuda_device)
        out = torch.zeros_like(B)
        for mode in (prox_cuda.PHASE_RECURRENCE, prox_cuda.PHASE_STAGING,
                     prox_cuda.PHASE_WALK):
            prox_cuda._t_smooth_phase(mode, B, rho, 1000.0, dbg, out)
        torch.cuda.synchronize()
        coef = dbg.view(512, 4).cpu()
        assert torch.equal(coef[:, 0], rho.cpu()) and bool((coef[:, 2] > 0).all())
        assert coef[0, 1] == 0 and bool((coef[1:, 1] < 0).all())   # m_0, m_k
        assert _same_bits(out, prox_cuda.t_smooth_cols(B, rho, 1000.0))
        # the whole kernel with its stamps: every span of every block ends
        # after it starts, and the prox is the kernel's
        stamps = torch.zeros((16, prox_cuda.T_STAMPS), dtype=torch.int64,
                             device=cuda_device)
        whole = torch.zeros_like(B)
        prox_cuda._t_smooth_phase(prox_cuda.PHASE_ALL, B, rho, 1000.0, None,
                                  whole, stamps=stamps)
        st = stamps.cpu()
        assert _same_bits(whole, out)
        for a, b in ((0, 1), (0, 2), (0, 3), (3, 4), (5, 6)):
            assert bool((st[:, b] > st[:, a]).all()), (a, b)


def _near_midpoint(p, count, seed):
    """(A, B) significand pairs of precision p, as float64 numpy arrays of
    integers, whose quotient lies within |t| / B of a rounding midpoint
    (t odd, |t| <= 5), as close as two p-bit numbers' quotient comes: B
    odd, M = t / B modulo 2^(p + 1) an odd p + 1-bit integer, A = (B M -
    t) / 2^(p + 1), so A / B = (M - t / B) / 2^(p + 1)."""
    rng = np.random.default_rng(seed)
    mod = 2 ** (p + 1)
    A, B = [], []
    while len(A) < count:
        b = int(rng.integers(2 ** (p - 2), 2 ** (p - 1))) * 2 + 1
        t = int(rng.choice([-5, -3, -1, 1, 3, 5]))
        m = t * pow(b, -1, mod) % mod
        if m >= 2 ** p:
            A.append((b * m - t) // mod)
            B.append(b)
    return np.array(A, dtype=np.float64), np.array(B, dtype=np.float64)


def _division_pairs(dt, n_per_class, gen, device):
    """(n, d) pairs of the classes that reach the correction's hard cases
    and its guard: random numerators across 2^+-70 over divisors in the
    range d'_k takes ([1e-6, 5e6]), divisors with all-ones significands,
    quotients within a few ulps of a power of two, quotients next to a
    rounding midpoint (built on purpose, 400,000 a dtype), both operands
    across the whole exponent range, and zeros, negative zeros,
    subnormals, infinities, NaN, zero and negative divisors."""
    p = 53 if dt == torch.float64 else 24
    emax = 1023 if dt == torch.float64 else 127

    def u(lo, hi):
        return torch.rand(n_per_class, generator=gen, device=device,
                          dtype=torch.float64) * (hi - lo) + lo

    def ints(lo, hi):
        return torch.randint(lo, hi, (n_per_class,), generator=gen,
                             device=device).to(torch.float64)

    sign = torch.where(u(0, 1) < 0.5, -1.0, 1.0)
    pairs = []
    # random numerators over the divisors d'_k takes
    pairs.append((sign * u(1, 2) * 2.0 ** ints(-70, 71),
                  10.0 ** u(-6, 6.7)))
    # all-ones significands
    ones = (2.0 ** p - 1) * 2.0 ** ints(-p - 20, -p + 23)
    pairs.append((sign * u(1, 2) * 2.0 ** ints(-30, 31), ones))
    # quotients near powers of two: n = d 2^k, moved a few ulps
    d = u(1, 4000).to(dt)
    n = (d.double() * 2.0 ** ints(-30, 31)).to(dt)
    for _ in range(3):
        step = u(0, 1) < 0.5
        n = torch.where(step, torch.nextafter(n, torch.zeros_like(n)),
                        torch.nextafter(n, torch.full_like(n, float("inf"))))
    pairs.append((n, d))
    # both across the whole exponent range
    pairs.append((sign * u(1, 2) * 2.0 ** ints(-emax, emax),
                  u(1, 2) * 2.0 ** ints(-emax, emax)))
    # quotients next to a midpoint, scaled into the window
    A, B = (torch.tensor(v, device=device) for v in _near_midpoint(p, 400_000, p))
    m = A.numel()
    pairs.append((torch.where(u(0, 1)[:m] < 0.5, -1.0, 1.0) * A
                  * 2.0 ** (ints(-40, 41)[:m] - p),
                  B * 2.0 ** (ints(-20, 21)[:m] - p)))
    out_n, out_d = [], []
    for a, b in pairs:
        out_n.append(a.to(dt))
        out_d.append(b.to(dt))
    tiny = torch.finfo(dt).tiny
    sp = torch.tensor([0.0, -0.0, tiny / 8, -tiny / 3, float("inf"),
                       -float("inf"), float("nan"), 1.0, -1.5, 3.0],
                      dtype=dt, device=device)
    sn, sd = torch.meshgrid(sp, torch.cat([sp, torch.tensor(
        [-2.0, 2.0 ** 61, 2.0 ** -61], dtype=dt, device=device)]),
        indexing="ij")
    out_n.append(sn.reshape(-1))
    out_d.append(sd.reshape(-1))
    return torch.cat(out_n).contiguous(), torch.cat(out_d).contiguous()


def test_torch_t_smooth_division_step_is_ieee(cuda_device):
    """The back substitution's division step (the reciprocal correction,
    or the full division outside its window) against __fdiv_rn and
    __ddiv_rn, bit for bit, on more than 10^7 pairs a dtype."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(14)
    for dt in (torch.float32, torch.float64):
        n, d = _division_pairs(dt, 2_600_000, gen, cuda_device)
        assert n.numel() >= 10_000_000
        q, ref = prox_cuda._t_smooth_div(n, d)
        iv = torch.int64 if dt == torch.float64 else torch.int32
        differ = q.view(iv) != ref.view(iv)
        assert not bool(differ.any()), (
            dt, int(differ.sum()), n[differ][:4].tolist(), d[differ][:4].tolist())


@pytest.mark.parametrize("config", par2_surface.CONFIGS)
def test_torch_par2_fit_on_cuda_matches_cpu(cuda_device, config):
    """Each PARAFAC2 surface configuration (utils/par2_surface.py) at K = 8
    slices on the card and on the CPU in float64 from one init state, 3
    outer iterations (the unimodal one's Bk constraint switched on at the
    second): the four streams at rtol 1e-8, and the configuration's kernel
    launched on the card."""
    spec, data_c = par2_surface.build_problem(config, "cpu", torch.float64, K=8)
    state0 = state_to_numpy(init_coupled(
        spec, data_c, par2_surface.surface_init_options(config), seed=2))
    opts = par2_surface.surface_options(config, 3, AbsFuncTol=0.0,
                                        OuterRelTol=0.0)
    if config == "unimodal":
        opts = dataclasses.replace(opts, iter_start_PAR2Bkconstraint=2)
    _, out_cpu = tp.fit(spec, data_c, state_from_numpy(state0, "cpu"), opts)
    _, data_d = par2_surface.build_problem(config, cuda_device, torch.float64,
                                           K=8)
    counter = {"unimodal": prox_cuda.project_isotonic_cols,
               "ragged": prox_cuda.project_isotonic_cols,
               "tv": prox_cuda.prox_tv_cols,
               "tparafac2": prox_cuda.t_smooth_cols,
               "coupled": mttkrp3}[config]
    before = counter.launches
    _, out = tp.fit(spec, data_d, state_from_numpy(state0, cuda_device), opts)
    assert counter.launches > before
    for a, b in [(out.func_val_conv, out_cpu.func_val_conv),
                 (out.func_coupl_conv, out_cpu.func_coupl_conv),
                 (out.func_constr_conv, out_cpu.func_constr_conv),
                 (out.func_PAR2_coupl, out_cpu.func_PAR2_coupl)]:
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0)
