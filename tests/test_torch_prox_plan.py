"""The host side of the sequential-prox kernels' two routes (ops/prox_cuda.py,
csrc/prox_seq.cu), on the CPU: the route and state plan of kernels A and B
at and around the shared route's limit, the global route's workspace
slices, the unimodal peak as the cluster kernel reduces it (against the
plain rule and jnp.argmin), and the plain walk's stop at slot 0.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matlab_code_tpu_torch.ops import isotonic as tiso
from matlab_code_tpu_torch.ops import prox_cuda

LIMIT = prox_cuda.SMEM_LIMIT
A_LAST = LIMIT // 36 - 1            # the longest column of kernel A's shared route
B_LAST = {torch.float64: LIMIT // 16, torch.float32: LIMIT // 12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_isotonic_plan_at_its_limit(dtype):
    """36 bytes a slot, slots 0..n, whatever the dtype, on either route;
    the shared route up to the last n whose state fits, the global route
    after."""
    assert prox_cuda.plan_isotonic(512, 16, dtype) == ("shared", 36 * 513)
    assert prox_cuda.plan_isotonic(4096, 20, dtype) == ("shared", 36 * 4097)
    assert prox_cuda.plan_isotonic(A_LAST, 1, dtype) == ("shared", 36 * (A_LAST + 1))
    assert 36 * (A_LAST + 1) <= LIMIT < 36 * (A_LAST + 2)
    assert prox_cuda.plan_isotonic(A_LAST + 1, 1, dtype) == ("global", 36 * (A_LAST + 2))
    assert prox_cuda.plan_isotonic(8192, 3, dtype) == ("global", 36 * 8193)
    assert prox_cuda.plan_isotonic(1, 1, dtype) == ("shared", 72)


@pytest.mark.parametrize("dtype,item", [(torch.float32, 4), (torch.float64, 8)])
def test_torch_tv_plan_at_its_limit(dtype, item):
    """(8 + itemsize) bytes a row: the column as doubles and the output in
    the storage type, so float32 keeps the shared route further."""
    last = B_LAST[dtype]
    assert prox_cuda.plan_tv(256, 16, dtype) == ("shared", (8 + item) * 256)
    assert prox_cuda.plan_tv(last, 2, dtype) == ("shared", (8 + item) * last)
    assert (8 + item) * last <= LIMIT < (8 + item) * (last + 1)
    assert prox_cuda.plan_tv(last + 1, 2, dtype) == ("global", (8 + item) * (last + 1))
    assert prox_cuda.plan_tv(20480, 2, dtype) == ("global", (8 + item) * 20480)
    assert B_LAST[torch.float32] > B_LAST[torch.float64] > 14000


def test_torch_prox_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="float32 or float64"):
        prox_cuda.plan_isotonic(10, 2, torch.float16)
    with pytest.raises(ValueError, match="float32 or float64"):
        prox_cuda.plan_tv(10, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="n, R >= 1"):
        prox_cuda.plan_tv(0, 2, torch.float32)


@pytest.mark.parametrize("state", [36 * 2, 36 * 8193, 12 * 20480, 16 * 20481, 128])
def test_torch_workspace_slices_hold_the_state_in_whole_lines(state):
    """A block's slice of the global route's workspace holds its state,
    starts on a 128-byte line (so on the 16 bytes the C entry asks for)
    and wastes less than a line."""
    stride = prox_cuda.workspace_stride(state)
    assert stride % 128 == 0 and state <= stride < state + 128


def _peak_by_threads(errs, threads):
    """The unimodal peak as the cluster kernel (csrc/prox_seq.cu
    unimodal_cluster) reduces it: the 0-based index of the first NaN of
    errs, else of its first minimum.
    Thread t takes entries t, t + threads, ...; the warps' partials meet in
    a shuffle tree (offsets 16 .. 1), then thread 0 takes the warps' in
    turn.  Each step keeps the least (not NaN, value, index) key, so the
    answer is jnp.argmin's whatever the order."""
    def before(a, b):
        if a[1] != b[1]:
            return a[1] > b[1]
        if not a[1] and a[0] != b[0]:
            return a[0] < b[0]
        return a[2] < b[2]

    start = (math.inf, 0, 2**31 - 1)
    part = [start] * threads
    for i, e in enumerate(errs):
        q = (e, int(e != e), i)
        if before(q, part[i % threads]):
            part[i % threads] = q
    warps = []
    for w in range(0, threads, 32):
        lanes = part[w:w + 32]
        off = 16
        while off >= 1:
            lanes = [lanes[j + off] if j + off < 32 and before(lanes[j + off], lanes[j])
                     else lanes[j] for j in range(32)]
            off //= 2
        warps.append(lanes[0])
    best = warps[0]
    for p in warps[1:]:
        if before(p, best):
            best = p
    return best[2]


def _peak_cases():
    rng = np.random.default_rng(5)
    nan, inf = math.nan, math.inf
    yield "one", [2.0]
    yield "ties", [3.0, 1.0, 2.0, 1.0, 1.0, 5.0]
    yield "signed zeros", [0.5, -0.0, 0.0, -0.0]
    yield "leading NaN", [nan, 0.0, -1.0, nan]
    yield "inner NaN", [4.0, -2.0, 1.0, nan, -3.0, nan]
    yield "infinities", [inf, -inf, 3.0, -inf, inf]
    yield "all inf", [inf] * 7
    yield "all NaN", [nan] * 3
    long = np.round(rng.standard_normal(700) * 4) / 4       # many ties
    yield "long, ties", list(long)
    yield "long, min late", list(np.r_[long, long.min() - 1, long.min() - 1])
    yield "long, NaN at 301", list(np.r_[long[:301], nan, long[301:]])
    yield "long, NaN late, -inf early", list(np.r_[-inf, long, nan])


@pytest.mark.parametrize("threads", [32, 64, prox_cuda.THREADS])
def test_torch_parallel_peak_rule_matches_argmin(threads):
    """The cluster kernel's peak (each thread a strided share, a shuffle
    tree a warp, then the warps in turn) is the plain rule's
    (_argmin_first: the first NaN, else the first minimum) and jnp.argmin's,
    on ties, leading and inner NaNs, -inf and inf."""
    for label, vals in _peak_cases():
        want = tiso._argmin_first(vals)
        assert _peak_by_threads(vals, threads) == want, label
        assert int(jnp.argmin(jnp.asarray(vals, dtype=jnp.float64))) == want, label


def _fill_by_sets(level, idxr, m, n):
    """The shared route's fill of a prefix fit (csrc/prox_seq.cu fill_fit):
    the sets' right ends listed from m by the level-set pointers, each row
    finding its set by a binary search."""
    ends, idx = [], m
    while idx >= 1:
        ends.append(idx)
        idx = idxr[idx] - 1
    out = [0.0] * n
    for j in range(1, m + 1):
        lo, hi = 0, len(ends) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if ends[mid] >= j:
                lo = mid
            else:
                hi = mid - 1
        out[j - 1] = level[ends[lo]]
    return out


@pytest.mark.parametrize("n", [1, 7, 64])
def test_torch_fill_by_sets_matches_reconstruct(n):
    """Rows filled by set lookup give the pointer walk's fit at every
    prefix length, on a normal column, ties and a non-negative scan."""
    rng = np.random.default_rng(n)
    for y in (list(rng.standard_normal(n)),
              list(np.round(rng.standard_normal(n))),
              list(np.sort(rng.standard_normal(n)))):
        for nonneg in (False, True):
            level, idxr, _ = tiso._prefix_isotonic(y, nonneg)
            for m in range(n + 1):
                assert (_fill_by_sets(level, idxr, m, n)
                        == tiso._reconstruct(m, level, idxr, n))


@pytest.mark.parametrize("nonneg", [False, True])
def test_torch_plain_walk_stops_at_slot_0(nonneg):
    """A column holding -inf (first, inner, twice in a row, last) ends:
    no merge reaches past slot 0, as in the kernel, whose slot-0 level is
    NaN.  On finite columns the stop changes nothing (the JAX package's
    sentinel level -inf is never merged into)."""
    inf = math.inf
    for y in ([-inf, 0.5, -1.0], [1.0, -inf, -inf, 2.0], [0.3, 0.1, -inf],
              [-inf]):
        level, idxr, err = tiso._prefix_isotonic(y, nonneg)
        assert all(1 <= idxr[i] <= i for i in range(1, len(y) + 1))
        assert len(tiso.unimodal_list(y, nonneg)) == len(y)
        assert tiso.isotonic_list(y, True)[0] == -inf
        assert tiso.isotonic_list([-v for v in y], False)[0] == inf
    y = [0.3, 0.1, 0.2, -0.5]
    steps = []
    assert tiso._prefix_isotonic(y, nonneg, steps)[1][1:] == [1, 1, 1, 1]
    assert steps == [4 + 3]
