"""The port's sharded MTTKRPs (matlab_code_tpu_torch/parallel/
shard_mttkrp.py) on 2 gloo ranks, and the ring on 4, against the JAX
package's make_sharded_mttkrp* on make_mesh(n) of this process's virtual
devices: the bulk psum, the all_gather of the cut mode, the ring, the
nnz-cut COO psum and a matrix's product, rtol 1e-12, every rank's result
bit-equal.  The ranks are OS processes (tests/torch_mesh_worker.py), one
start for the file."""
import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from matlab_code_tpu.parallel import shard_mttkrp as jsm
from matlab_code_tpu.parallel.sharding import DATA_AXIS, make_mesh
from matlab_code_tpu.problem import SparseTensor as JSparse

import torch_mesh_cases as mc

SHAPE, R = (16, 24, 12), 3
MATRIX = (16, 12)


def _cases(n):
    """{label: (X, factors, shard_dim, target, form)}: numpy operands."""
    rng = np.random.default_rng(11 + n)
    X = rng.standard_normal(SHAPE)
    facs = [rng.standard_normal((s, R)) for s in SHAPE]
    cases = {}
    if n == 2:
        for sd in (0, 1):
            for t in range(3):
                form = "gather" if t == sd else "psum"
                cases[f"{form}_s{sd}_t{t}"] = (X, facs, sd, t, "bulk")
        for t in (1, 2):
            cases[f"ring_s0_t{t}"] = (X, facs, 0, t, "ring")
        M = rng.standard_normal(MATRIX)
        mf = [rng.standard_normal((s, R)) for s in MATRIX]
        for sd in (0, 1):
            for t in (0, 1):
                cases[f"matrix_s{sd}_t{t}"] = (M, mf, sd, t, "bulk")
        Xs = X.copy()
        Xs[rng.uniform(size=SHAPE) < 0.7] = 0.0
        idx = np.argwhere(Xs != 0).astype(np.int32)
        val = Xs[tuple(idx.T)]
        pad = (-len(val)) % n
        idx = np.concatenate([idx, np.zeros((pad, 3), np.int32)])
        val = np.concatenate([val, np.zeros(pad)])
        for t in range(3):
            cases[f"sparse_t{t}"] = ((idx, val, SHAPE), facs, None, t,
                                     "sparse")
    else:
        cases["ring_s0_t1"] = (X, facs, 0, 1, "ring")
        cases["ring_s2_t0"] = (X, facs, 2, 0, "ring")
        cases["ring_s2_t1"] = (X, facs, 2, 1, "ring")
    return cases


def _jax(n, case):
    """The JAX package's sharded MTTKRP of one case on make_mesh(n)."""
    X, facs, sd, t, form = case
    mesh = make_mesh(n)
    if form == "sparse":
        idx, val, shape = X
        st = JSparse(jax.device_put(idx, NamedSharding(mesh, P(DATA_AXIS,
                                                               None))),
                     jax.device_put(val, NamedSharding(mesh, P(DATA_AXIS))))
        f = jsm.make_sharded_mttkrp_sparse(mesh, DATA_AXIS, t, shape[t])
        return np.asarray(f(st, tuple(jax.numpy.asarray(a) for a in facs)))
    spec = [None] * X.ndim
    spec[sd] = DATA_AXIS
    Xsh = jax.device_put(X, NamedSharding(mesh, P(*spec)))
    fsh = tuple(jax.device_put(a, NamedSharding(
        mesh, P(DATA_AXIS, None) if i == sd else P(None, None)))
        for i, a in enumerate(facs))
    if form == "ring":
        f = jsm.make_sharded_mttkrp_pipelined(mesh, DATA_AXIS, X.ndim, sd, t,
                                              n)
    else:
        f = jsm.make_sharded_mttkrp(mesh, DATA_AXIS, X.ndim, sd, t)
    return np.asarray(jax.jit(f)(Xsh, fsh))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: (cases, every rank's results, the JAX results)}."""
    started = {}
    for n in (2, 4):
        cases = _cases(n)
        started[n] = (cases, mc.start_ranks(
            tmp_path_factory.mktemp(f"mttkrp{n}"),
            [("mttkrp", "mttkrp", {"cases": cases})], n=n))
    out = {}
    for n, (cases, ranks) in started.items():
        want = {k: _jax(n, c) for k, c in cases.items()}
        out[n] = (cases, [r["mttkrp"] for r in ranks.results()], want)
    return out


def _hold(runs, n, prefix):
    cases, ranks, want = runs[n]
    labels = [k for k in cases if k.startswith(prefix)]
    assert labels
    for k in labels:
        for res in ranks:
            np.testing.assert_allclose(res[k], want[k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)
            np.testing.assert_array_equal(res[k], ranks[0][k])


def test_torch_mesh_mttkrp_psum(runs):
    _hold(runs, 2, "psum")


def test_torch_mesh_mttkrp_all_gather(runs):
    _hold(runs, 2, "gather")


def test_torch_mesh_mttkrp_ring_two_ranks(runs):
    _hold(runs, 2, "ring")


def test_torch_mesh_mttkrp_ring_four_ranks(runs):
    _hold(runs, 4, "ring")


def test_torch_mesh_mttkrp_sparse(runs):
    _hold(runs, 2, "sparse")


def test_torch_mesh_mttkrp_matrix(runs):
    _hold(runs, 2, "matrix")


def test_torch_mesh_mttkrp_collective_counts(runs):
    """Each form runs its collectives only: a psum or an all_gather a bulk
    call, n - 1 ring steps and one all_gather a ring call, one psum a COO
    call (the dense cases are called twice, the COO ones once)."""
    for n in (2, 4):
        cases, ranks, _ = runs[n]
        forms = [(c[4], c[2] == c[3]) for c in cases.values()]
        n_psum = sum(2 if f == "bulk" else 1 for f, same in forms
                     if f == "sparse" or (f == "bulk" and not same))
        n_ring = sum(2 for f, _ in forms if f == "ring")
        n_gather = sum(2 for f, same in forms if f == "bulk" and same)
        for res in ranks:
            assert res["counts"]["psum"] == n_psum
            assert res["counts"]["all_gather"] == n_gather + n_ring
            assert res["counts"]["ring"] == n_ring * (n - 1)
