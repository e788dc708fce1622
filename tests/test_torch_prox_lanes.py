"""The host side of the sequential-prox kernels' lanes route (ops/prox_cuda.py,
csrc/prox_seq.cu: a thread a column's scan side, a warp 32 columns), on the
CPU: the plans' route around the crossover and their refusals, the ragged
form of the monotone, unimodal and TV proxes (one call for a padded ragged
stack) against the JAX package's size buckets and the port's, and Python
mirrors of the lanes kernels' scan, fill and split peak search.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matlab_code_tpu.models import admm as jadmm
from matlab_code_tpu.ops import prox as jprox
from matlab_code_tpu_torch.models import admm as tadmm
from matlab_code_tpu_torch.ops import isotonic as tiso
from matlab_code_tpu_torch.ops import prox as tprox
from matlab_code_tpu_torch.ops import prox_cuda

LANES = prox_cuda.LANES
MIN = prox_cuda.LANES_MIN_COLS
# the ragged stack: 6 slices of J_k rows in 3..9, R 3, and rho a slice
SIZES = (5, 9, 3, 9, 7, 4)
KINDS = (("unimodality", (True,)), ("non-decreasing", ()),
         ("TV regularization", (1e-3,)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_plans_take_the_lanes_route_from_the_crossover(dtype):
    """K R >= LANES_MIN_COLS columns take the lanes route, whatever n; below
    it the block routes hold (the CP surface's (n, R) matrices among
    them)."""
    item = 4 if dtype == torch.float32 else 8
    assert MIN % 32 == 0
    K = MIN // 32
    assert prox_cuda.plan_isotonic(256, 32, dtype, K) == (LANES, 44 * 257)
    assert prox_cuda.plan_isotonic(256, 32, dtype, K - 1)[0] == "shared"
    assert prox_cuda.plan_isotonic(256, MIN - 1, dtype)[0] == "shared"
    assert prox_cuda.plan_isotonic(256, MIN, dtype)[0] == LANES
    assert prox_cuda.plan_isotonic(8192, 3, dtype, MIN)[0] == LANES
    assert prox_cuda.plan_isotonic(8192, 3, dtype, 2)[0] == "global"
    assert prox_cuda.plan_tv(256, 32, dtype, K) == (LANES, item * 256)
    assert prox_cuda.plan_tv(256, 32, dtype, K - 1) == ("shared", (8 + item) * 256)
    assert prox_cuda.plan_isotonic(256, 32, dtype, 512)[0] == LANES
    assert prox_cuda.plan_tv(256, 32, dtype, 512)[0] == LANES
    for n, R in ((512, 16), (256, 16), (4096, 20), (256, 40)):
        assert prox_cuda.plan_isotonic(n, R, dtype)[0] == "shared"
        assert prox_cuda.plan_tv(n, R, dtype)[0] == "shared"


def test_torch_lanes_route_refusals():
    """The plans refuse K < 1; a ragged stack takes only the lanes route,
    only as a (K, n, R) stack, and only with K lengths in 1..n (all checked
    before anything reaches the card)."""
    with pytest.raises(ValueError, match="K >= 1"):
        prox_cuda.plan_isotonic(10, 2, torch.float32, 0)
    with pytest.raises(ValueError, match="K >= 1"):
        prox_cuda.plan_tv(10, 2, torch.float64, 0)
    X = torch.zeros(3, 6, 2)
    with pytest.raises(ValueError, match="lanes route"):
        prox_cuda._isotonic(X, 2, True, "shared", sizes=(1, 2, 3))
    with pytest.raises(ValueError, match="lanes route"):
        prox_cuda._tv(X, 0.1, "global", sizes=(1, 2, 3))
    with pytest.raises(ValueError, match=r"\(K, n, R\) stack"):
        prox_cuda._isotonic(X[0], 0, False, sizes=(3,))
    for bad in ((1, 2), (0, 2, 3), (1, 7, 3)):
        with pytest.raises(ValueError, match="slice lengths"):
            prox_cuda._sizes_on(bad, 3, 6, "cpu")
    got = prox_cuda._sizes_on((1, 6, 3), 3, 6, "cpu")
    assert got.dtype == torch.int32 and got.tolist() == [1, 6, 3]
    assert prox_cuda._sizes_on([1, 6, 3], 3, 6, "cpu") is got


def _ragged(seed=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((len(SIZES), max(SIZES), 3))
    for k, J in enumerate(SIZES):
        X[k, J:] = 0.0
    X[1, :, 2] = np.round(2 * X[1, :, 2]) / 2       # ties
    X[3, :, 1] = -np.abs(X[3, :, 1]) - 0.1          # all negative
    return X, rng.uniform(0.5, 2.0, len(SIZES))


@pytest.mark.parametrize("kind,params", KINDS)
def test_torch_ragged_form_matches_jax_buckets(kind, params):
    """The ragged form prox(x, rho, sizes=J_k) of make_prox's monotone,
    unimodal and TV proxes, on a padded stack of 6 slices (J_k in 3..9,
    R 3), against the JAX package's prox_slicewise_ragged with its
    make_prox (a vmapped prox a size bucket) at rtol 1e-12; the padded
    rows exactly zero."""
    X, rho = _ragged()
    spec = tprox.ConstraintSpec(kind, params)
    pf, _ = tprox.make_prox(spec, max(SIZES))
    assert pf.takes_sizes
    got = pf(torch.tensor(X), torch.tensor(rho)[:, None, None], sizes=SIZES)
    jpf, _ = jprox.make_prox(jprox.ConstraintSpec(kind, params), max(SIZES))
    want = np.asarray(jadmm.prox_slicewise_ragged(
        jpf, jnp.asarray(X), jnp.asarray(rho), SIZES))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-300)
    for k, J in enumerate(SIZES):
        assert not bool(got[k, J:].any())


@pytest.mark.parametrize("kind,params", KINDS + (("non-increasing", ()),
                                                 ("unimodality", (False,))))
def test_torch_ragged_form_is_the_buckets_bit_for_bit(kind, params):
    """On the CPU the ragged form runs the plain version on each slice's
    true rows: the port's size buckets (prox_slicewise_ragged, which keeps
    them on the CPU) to the last bit, in float64 and float32; a prox
    without the ragged form (simplex) keeps the buckets on the card too."""
    X, rho = _ragged(7)
    pf, _ = tprox.make_prox(tprox.ConstraintSpec(kind, params), max(SIZES))
    for dt in (torch.float64, torch.float32):
        Xt, rt = torch.tensor(X, dtype=dt), torch.tensor(rho, dtype=dt)
        got = pf(Xt, rt[:, None, None], sizes=SIZES)
        want = tadmm.prox_slicewise_ragged(pf, Xt, rt, SIZES)
        assert got.dtype == dt and torch.equal(got, want)
    simplex, _ = tprox.make_prox(
        tprox.ConstraintSpec("simplex column-wise", (1.0,)), max(SIZES))
    assert not getattr(simplex, "takes_sizes", False)


def _lanes_walk(y, nonneg):
    """The lanes route's scan (csrc/prox_seq.cu scan_step with Lanes): slot
    i - 1's set carried from the step before, each slot keeping the level
    and err just before its set (blev, berr) so a merge reads one slot.
    Returns (sumwy, idxr, err) of slots 0..n."""
    n = len(y)
    sumwy, sumwy2, err = [0.0] * (n + 1), [0.0] * (n + 1), [0.0] * (n + 1)
    idxr, blev, berr = [0] * (n + 1), [math.nan] * (n + 1), [0.0] * (n + 1)
    cum, top, top_err = 0.0, math.nan, 0.0
    top_swy = top_swy2 = 0.0
    top_left, below_lev, below_err = 0, math.nan, 0.0
    for i in range(1, n + 1):
        yi = y[i - 1]
        swy, swy2, sw, lev, left = yi, yi * yi, 1.0, yi, i
        prev, below = top, top_err
        if lev <= prev:
            swy += top_swy
            swy2 += top_swy2
            sw += float(i - 1 - top_left + 1)
            lev = swy / sw
            left, prev, below = top_left, below_lev, below_err
        while lev <= prev:
            mg = left - 1
            swy += sumwy[mg]
            swy2 += sumwy2[mg]
            sw += float(mg - idxr[mg] + 1)
            lev = swy / sw
            left, prev, below = idxr[mg], blev[mg], berr[mg]
        sumwy[i], sumwy2[i], idxr[i], blev[i] = swy, swy2, left, prev
        levelerror = swy2 - swy * swy / sw
        top_err = cum if nonneg and lev < 0 else levelerror + below
        err[i], berr[i] = top_err, below
        cum += yi * yi
        top_swy, top_swy2, top_left = swy, swy2, left
        below_lev, below_err, top = prev, below, lev
    return sumwy, idxr, err


def _fill_lanes(sumwy, idxr, m, length, flip, n, nonneg):
    """A lane's fill (csrc/prox_seq.cu fill_lanes): slots from `length`
    down, slot j < left starting the next set, whose level is sumwy[j] /
    (j - left + 1); slot j at row j - 1, or m - j where the scan ran
    flipped; rows the prefix does not reach are left as None."""
    out = [None] * n
    left, v = math.inf, 0.0
    for j in range(n, 0, -1):
        if j > length:
            continue
        if j < left:
            left = idxr[j]
            v = sumwy[j] / float(j - left + 1)
            v = 0.0 if nonneg and v < 0 else v
        out[m - j if flip else j - 1] = v
    return out


@pytest.mark.parametrize("m", [1, 2, 9, 40, 300])
def test_torch_lanes_walk_and_fill_match_the_plain_walk(m):
    """The lanes scan gives the plain walk's set pointers and errors to the
    last bit (its merges read the level and err kept at the merged slot,
    not at the slot before the set), and its fill, levels taken as sums
    over counts, the pointer walk's fit at every prefix length, forward and
    flipped, in a column padded past its m rows; on normal columns, ties,
    a decreasing column (a merge every step) and -inf / NaN entries."""
    rng = np.random.default_rng(m)
    n = m + 3
    cols = [list(rng.standard_normal(m)), list(np.round(rng.standard_normal(m))),
            list(np.sort(rng.standard_normal(m))[::-1])]
    if m > 2:
        cols.append([-math.inf] + cols[0][1:-1] + [math.nan])
    for y in cols:
        for nonneg in (False, True):
            level, idxr, err = tiso._prefix_isotonic(y, nonneg)
            sumwy, idxr_l, err_l = _lanes_walk(y, nonneg)
            assert idxr_l[1:] == idxr[1:]
            np.testing.assert_array_equal(err_l[1:], err[1:])
            for length in range(0, m + 1, max(1, m // 20)):
                fit = tiso._reconstruct(length, level, idxr, m)[:length]
                got = _fill_lanes(sumwy, idxr_l, m, length, False, n, nonneg)
                np.testing.assert_array_equal(got[:length], fit)
                assert got[length:] == [None] * (n - length)
                got = _fill_lanes(sumwy, idxr_l, m, length, True, n, nonneg)
                np.testing.assert_array_equal(got[m - length:m], fit[::-1])


def _split_peak(errs):
    """The lanes kernel's peak (unimodal_lanes): warp 0 keeps the least of
    the first half of the 1-based indices, warp 1 of the second, then warp 0
    takes warp 1's if it comes before (not NaN, value, index)."""
    def key(i):
        e = errs[i - 1]
        return (0 if e != e else 1, 0.0 if e != e else e, i)
    m = len(errs)
    half = (m + 1) // 2
    parts = [min((key(i) for i in range(lo, hi + 1)), default=None)
             for lo, hi in ((1, half), (half + 1, m))]
    best = parts[0] if parts[1] is None or parts[0] <= parts[1] else parts[1]
    return best[2] - 1


def test_torch_lanes_split_peak_matches_argmin():
    """The two warps' split search finds the plain rule's peak
    (_argmin_first: the first NaN, else the first minimum) and
    jnp.argmin's, on ties, NaNs, infinities and long columns."""
    nan, inf = math.nan, math.inf
    rng = np.random.default_rng(11)
    long = list(np.round(rng.standard_normal(257) * 4) / 4)
    for vals in ([2.0], [1.0, 1.0], [3.0, 1.0, 2.0, 1.0, 1.0, 5.0],
                 [0.5, -0.0, 0.0, -0.0], [nan, 0.0, -1.0, nan],
                 [4.0, -2.0, 1.0, nan, -3.0, nan], [inf, -inf, 3.0, -inf, inf],
                 [inf] * 7, [nan] * 3, long, long + [min(long) - 1],
                 long[:200] + [nan] + long[200:]):
        want = tiso._argmin_first(vals)
        assert _split_peak(vals) == want
        assert int(jnp.argmin(jnp.asarray(vals, dtype=jnp.float64))) == want
