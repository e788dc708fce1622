"""The port's sparse COO CP path against the JAX package: the plain sparse
MTTKRP, the kernel's plan layout, the sparse fit (golden cp_sparse.npz, the
JAX fit, the dense fit), nvecs init, the sparse input rules and the sparse
workload.

Data and init states come from the JAX package and cross to the port with
matlab_code_tpu_torch.convert; everything runs in float64 on the CPU, where
the kernel's wrapper takes its plain version.  tests/test_torch_sparse_cuda.py
holds the kernel itself against the plain version on a CUDA card.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.ops.tensor import mttkrp as jmttkrp
from matlab_code_tpu.ops.tensor import mttkrp_sparse as jmttkrp_sparse
from matlab_code_tpu.problem import ProblemData, SparseTensor as JSparseTensor
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data

import bench_large
import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, options_from_reference, spec_from_reference,
    state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models.init import init_coupled as tinit
from matlab_code_tpu_torch.models.solver import attach_sparse_plans
from matlab_code_tpu_torch.models.solver import fit as tfit
from matlab_code_tpu_torch.ops import sparse_cuda as sc
from matlab_code_tpu_torch.ops.tensor import mttkrp_sparse
from matlab_code_tpu_torch.utils import sparse_workload

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
NN = ConstraintSpec("non-negativity")


def _random_coo(rng, shape, nnz):
    """tests/test_sparse_pallas.py's draw: distinct coordinates, normal
    values."""
    idx = np.unique(
        (rng.integers(0, 1 << 30, size=(nnz, 3)) % np.asarray(shape))
        .astype(np.int32), axis=0)
    return idx, rng.standard_normal(len(idx))


def _coo_with_duplicates(seed=5, shape=(40, 23, 17), nnz=600):
    """Coordinates with duplicates, empty rows in every mode (only even
    indices drawn) and one mode-0 row of many chunks."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, (d + 1) // 2, nnz) * 2 for d in shape], 1)
    idx = np.concatenate([idx, idx[:80]])                  # duplicates
    long_row = np.stack([rng.integers(0, (d + 1) // 2, 12 * sc.CHUNK) * 2
                         for d in shape], 1)
    long_row[:, 0] = 6
    idx = np.concatenate([idx, long_row]).astype(np.int32)
    return idx, rng.standard_normal(len(idx))


@pytest.mark.parametrize("shape", [(300, 257, 129), (64, 64, 64),
                                   (1000, 40, 40)])
def test_torch_sparse_reference_matches_jax(shape):
    """tests/test_sparse_pallas.py's shapes: 20,000 draws, R 7."""
    rng = np.random.default_rng(3)
    idx, val = _random_coo(rng, shape, 20000)
    facs = [rng.standard_normal((d, 7)) for d in shape]
    for m in range(3):
        want = np.asarray(jmttkrp_sparse(
            jnp.asarray(idx), jnp.asarray(val),
            [jnp.asarray(f) for f in facs], m, shape[m]))
        got = mttkrp_sparse(torch.tensor(idx), torch.tensor(val),
                            [torch.tensor(f) for f in facs], m, shape[m])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_torch_sparse_reference_matches_dense_mttkrp():
    """tests/test_sparse_stepwise.py::test_mttkrp_sparse_matches_dense."""
    rng = np.random.default_rng(9)
    X = rng.standard_normal((7, 8, 9))
    X[rng.uniform(size=X.shape) < 0.6] = 0.0
    st = tp.SparseTensor.from_dense(torch.tensor(X))
    facs = [rng.standard_normal((s, 3)) for s in X.shape]
    for mode in range(3):
        want = np.asarray(jmttkrp(jnp.asarray(X), [jnp.asarray(f) for f in facs],
                                  mode))
        got = sc.mttkrp_sparse_reference(
            st.indices, st.values, [torch.tensor(f) for f in facs], mode,
            X.shape[mode])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def _check_plan_tables(plan, idx, val, shape, mode, order):
    """Every nonzero is in the plan exactly once (duplicates included) with
    its value, in `order`; rowptr is monotone, counts the rows and ends at
    nnz; the chunks tile each row in order, none empty or longer than the
    chunk."""
    nnz, D = len(idx), shape[mode]
    L = sc.CHUNK
    assert plan.coords.dtype == torch.int32 and plan.coords.shape == (nnz, 2)
    np.testing.assert_array_equal(sc._plan_indices(plan).numpy(), idx[order])
    np.testing.assert_array_equal(plan.vals.numpy(), val[order])
    np.testing.assert_array_equal(plan.coords.numpy(),
                                  idx[order][:, list(plan.gather_modes)])
    rowptr = plan.rowptr.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == nnz and len(rowptr) == D + 1
    assert np.all(np.diff(rowptr) >= 0)
    np.testing.assert_array_equal(np.diff(rowptr),
                                  np.bincount(idx[:, mode], minlength=D))
    cs, cp = plan.chunk_start.numpy(), plan.chunk_ptr.numpy()
    assert cs[0] == 0 and cs[-1] == nnz and cp[-1] == plan.nchunks
    lens = np.diff(cs)
    assert np.all(lens >= 1) and np.all(lens <= L)
    for r in range(D):
        if rowptr[r + 1] == rowptr[r]:
            assert cp[r + 1] == cp[r]             # an empty row has no chunk
        else:
            assert cs[cp[r]] == rowptr[r] and cs[cp[r + 1]] == rowptr[r + 1]
    assert (np.diff(rowptr) == 0).any()           # empty rows are there
    if mode == 0:
        assert np.diff(rowptr).max() > 10 * L     # and the long row


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_sparse_plan_invariants(mode):
    """The fiber-sorted layout of a 3-way tensor: the larger gathered mode
    resident (coords[:, 1]), nonzeros sorted stably by the target index and
    then by the fiber coordinate (coords[:, 0]), and the chunk tables of
    _check_plan_tables."""
    idx, val = _coo_with_duplicates()
    shape = (40, 23, 17)
    plan = sc.build_plan(torch.tensor(idx), torch.tensor(val), shape, mode, 5)
    gm = tuple(a for a in range(3) if a != mode)
    res = max(gm, key=lambda g: shape[g])
    fib = gm[0] if res == gm[1] else gm[1]
    assert (plan.variant, plan.lanes, plan.gather_modes) == ("fiber", 8,
                                                             (fib, res))
    order = np.lexsort((idx[:, fib], idx[:, mode]))    # stable, target first
    _check_plan_tables(plan, idx, val, shape, mode, order)
    rows = sc._plan_indices(plan).numpy()[:, mode]
    key = rows.astype(np.int64) * shape[fib] + plan.coords.numpy()[:, 0]
    assert np.all(np.diff(key) >= 0)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_sparse_chunk_plan_invariants(mode):
    """The layout of the chunk kernel, asked for by name: the gathered
    modes in ascending order and the nonzeros sorted stably by the target
    index alone.  Through the wrapper on the CPU it gives the plain
    result, as the fiber plan does."""
    idx, val = _coo_with_duplicates()
    shape = (40, 23, 17)
    plan = sc.build_plan(torch.tensor(idx), torch.tensor(val), shape, mode, 5,
                         variant="chunk")
    assert (plan.variant, plan.lanes) == ("chunk", 8)
    assert plan.gather_modes == tuple(a for a in range(3) if a != mode)
    _check_plan_tables(plan, idx, val, shape, mode,
                       np.argsort(idx[:, mode], kind="stable"))
    rng = np.random.default_rng(mode)
    facs = [torch.tensor(rng.standard_normal((d, 5))) for d in shape]
    fiber = sc.build_plan(torch.tensor(idx), torch.tensor(val), shape, mode, 5)
    want = sc.mttkrp_sparse_reference(torch.tensor(idx), torch.tensor(val),
                                      facs, mode, shape[mode])
    for p in (plan, fiber):
        np.testing.assert_allclose(sc.mttkrp_sparse_cuda(p, facs).numpy(),
                                   want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", [
    # (shape, mode, R, itemsize) -> (variant, P, gather_modes)
    (((2048,) * 3, 0, 16, 4), ("fiber", 16, (1, 2))),   # the sparse workload
    (((2048,) * 3, 1, 16, 4), ("fiber", 16, (0, 2))),
    (((2048,) * 3, 2, 16, 4), ("fiber", 16, (0, 1))),
    (((2048,) * 3, 0, 16, 8), ("fiber", 8, (1, 2))),    # float64: 256 KB at P 16
    (((2048,) * 3, 0, 32, 4), ("fiber", 16, (1, 2))),   # R 32: two tiles of 16
    (((2048,) * 3, 0, 8, 4), ("fiber", 8, (1, 2))),
    (((2048,) * 3, 0, 40, 4), ("fiber", 16, (1, 2))),
    (((40, 23, 17), 0, 40, 8), ("fiber", 16, (2, 1))),  # P <= FIBER_P_MAX
    (((9, 8, 7, 6), 0, 16, 4), ("chunk", 16, (1, 2, 3))),   # four-way
    (((50, 30), 1, 3, 8), ("chunk", 8, (0,))),              # a matrix
    (((64, 70000, 60000), 0, 16, 4), ("chunk", 16, (1, 2))),  # neither fits
    (((64, 70000, 60000), 1, 16, 4), ("fiber", 16, (2, 0))),  # 64 rows do
    (((64, 7264, 9000), 0, 16, 4), ("fiber", 8, (2, 1))),   # 7264 x 8 x 4 B fits
    (((64, 7265, 9000), 0, 16, 4), ("chunk", 16, (1, 2))),
])
def test_torch_sparse_kernel_choice(case):
    """choose_kernel, from the shape alone: the larger gathered mode whose
    column tile of P values fits the shared memory is resident, at the
    largest P <= min(lanes_for(R), FIBER_P_MAX); the chunk kernel
    everywhere else."""
    (shape, mode, R, itemsize), want = case
    got = sc.choose_kernel(shape, mode, R, itemsize)
    assert tuple(got) == want
    if got.variant == "fiber":
        assert shape[got.gather_modes[1]] * got.lanes * itemsize <= sc.SMEM_BYTES


def test_torch_sparse_build_plan_variants():
    """build_plan takes the chunk kernel when asked, refuses the fiber
    kernel where the shape does not take it, and records choose_kernel's
    choice otherwise."""
    idx = torch.tensor([[0, 1, 2, 3], [1, 0, 2, 1]], dtype=torch.int32)
    val = torch.ones(2, dtype=torch.float64)
    shape = (2, 2, 3, 4)
    assert sc.build_plan(idx, val, shape, 0, 4).variant == "chunk"
    with pytest.raises(ValueError, match="chunk kernel"):
        sc.build_plan(idx, val, shape, 0, 4, variant="fiber")
    with pytest.raises(ValueError, match="rank"):
        sc.build_plan(idx[:, :3], val, shape[:3], 0, 0)
    with pytest.raises(ValueError, match="fiber kernel"):
        sc.build_plan(idx[:, :3], val, shape[:3], 0, 4, variant="bogus")
    assert sc.fiber_blocks(0, 132) == 1 and sc.fiber_blocks(33, 132) == 2
    assert sc.fiber_blocks(40_100, 132) == 132
    assert [sc.fiber_lanes(P, b) for P, b in ((16, 4), (8, 4), (8, 8), (16, 8))
            ] == [4, 2, 4, 8]


def _fiber_walk(plan, facs, R):
    """csrc/mttkrp_sparse.cu's fiber_partials and row_sums in numpy, in the
    kernel's summation order: per column tile of P and per chunk, the warp
    takes 32 nonzeros a step and group g of its 32 / Q groups walks
    nonzeros gQ .. gQ + Q - 1 of each step, summing v * F_res[k] within a
    fiber and adding that times F_fib[j] where the fiber coordinate differs
    from the group's previous one; the groups are summed by the xor
    butterfly, then each row's chunk partials in chunk order."""
    P = plan.lanes
    Q = sc.fiber_lanes(P, plan.vals.element_size())
    G = 32 // Q
    fib, res = plan.gather_modes
    Ff, Fr = facs[fib].numpy(), facs[res].numpy()
    coords, vals = plan.coords.numpy(), plan.vals.numpy()
    cs, cp = plan.chunk_start.numpy(), plan.chunk_ptr.numpy()
    partial = np.full((plan.nchunks, R), np.nan)
    for r0 in range(0, R, P):
        cols = slice(r0, min(r0 + P, R))
        width = cols.stop - cols.start
        for c in range(plan.nchunks):
            lo, hi = cs[c], cs[c + 1]
            accs = []
            for g in range(G):
                acc, seg, fj, cur = np.zeros(width), np.zeros(width), 0.0, -1
                for base in range(lo, hi, 32):
                    for e in range(base + g * Q, min(base + g * Q + Q, hi)):
                        j, k = coords[e]
                        if j != cur:
                            acc, seg, cur, fj = acc + seg * fj, 0.0, j, Ff[j, cols]
                        seg = seg + vals[e] * Fr[k, cols]
                accs.append(acc + seg * fj)
            off = 1
            while off < G:
                accs = [accs[g] + accs[g ^ off] for g in range(G)]
                off <<= 1
            partial[c, cols] = accs[0]
    out = np.zeros((plan.out_dim, R))
    for row in range(plan.out_dim):
        for c in range(cp[row], cp[row + 1]):
            out[row] += partial[c]
    return out


@pytest.mark.parametrize("R", [5, 16, 40])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_sparse_fiber_walk_matches_plain(mode, R):
    """The fiber layout walked in the kernel's summation order (groups,
    fiber segments, chunk partials, row sums) at P 8 and 16 (three column
    tiles of 16 at R 40) equals the plain version."""
    idx, val = _coo_with_duplicates(seed=9)
    shape = (40, 23, 17)
    rng = np.random.default_rng(R)
    facs = [torch.tensor(rng.standard_normal((d, R))) for d in shape]
    plan = sc.build_plan(torch.tensor(idx), torch.tensor(val), shape, mode, R)
    assert plan.variant == "fiber"
    assert plan.lanes == min(sc.lanes_for(R), sc.FIBER_P_MAX)
    want = sc.mttkrp_sparse_reference(torch.tensor(idx), torch.tensor(val),
                                      facs, mode, shape[mode])
    np.testing.assert_allclose(_fiber_walk(plan, facs, R), want.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_torch_sparse_plan_walk_matches_plain(mode):
    """A torch walk of the layout the kernel reads: one partial row per
    chunk from coords and vals, then each row's partials summed in chunk
    order.  It equals the plain version, so the plan carries the right
    nonzeros, values and chunk tables."""
    idx, val = _coo_with_duplicates(seed=6)
    shape = (40, 23, 17)
    rng = np.random.default_rng(6)
    facs = [torch.tensor(rng.standard_normal((d, 5))) for d in shape]
    plan = sc.build_plan(torch.tensor(idx), torch.tensor(val), shape, mode, 5)
    B, C = (facs[g] for g in plan.gather_modes)
    contrib = (plan.vals[:, None] * B[plan.coords[:, 0].long()]
               * C[plan.coords[:, 1].long()])
    nnz_chunk = torch.repeat_interleave(torch.arange(plan.nchunks),
                                        torch.diff(plan.chunk_start))
    partial = torch.zeros((plan.nchunks, 5), dtype=torch.float64).index_add_(
        0, nnz_chunk, contrib)
    out = torch.zeros((shape[mode], 5), dtype=torch.float64)
    for r in range(shape[mode]):
        for c in range(int(plan.chunk_ptr[r]), int(plan.chunk_ptr[r + 1])):
            out[r] += partial[c]
    want = sc.mttkrp_sparse_reference(torch.tensor(idx), torch.tensor(val),
                                      facs, mode, shape[mode])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_torch_sparse_wrapper_on_cpu_takes_plain_version():
    idx, val = _coo_with_duplicates(seed=7)
    shape = (40, 23, 17)
    rng = np.random.default_rng(7)
    facs = [torch.tensor(rng.standard_normal((d, 3))) for d in shape]
    st = tp.SparseTensor(torch.tensor(idx), torch.tensor(val)).with_plans(shape,
                                                                          3)
    before = sc.mttkrp_sparse_cuda.launches
    for m in range(3):
        want = sc.mttkrp_sparse_reference(st.indices, st.values, facs, m,
                                          shape[m])
        got = sc.mttkrp_sparse_cuda(st.plans[m], facs)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
        got = mttkrp_sparse(st.indices, st.values, facs, m, shape[m],
                            plan=st.plans[m])
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sc.mttkrp_sparse_cuda.launches == before   # nothing launched
    with pytest.raises(ValueError, match="factors"):
        sc.mttkrp_sparse_cuda(st.plans[0], facs[:2])
    with pytest.raises(ValueError, match="outside shape"):
        sc.build_plan(st.indices, st.values, (40, 23, 16), 0, 3)


def test_torch_sparse_tensor_container():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((4, 5, 6))
    X[rng.uniform(size=X.shape) < 0.5] = 0.0
    st = tp.SparseTensor.from_dense(X)
    jst = JSparseTensor.from_dense(X)
    np.testing.assert_array_equal(st.indices.numpy(), np.asarray(jst.indices))
    np.testing.assert_array_equal(st.values.numpy(), np.asarray(jst.values))
    assert st.indices.dtype == torch.int32
    assert (st.ndim, st.dtype, st.device) == (3, torch.float64,
                                              torch.device("cpu"))
    np.testing.assert_array_equal(st.to_dense(X.shape).numpy(), X)
    planned = st.with_plans(X.shape, 2)
    assert [p.out_mode for p in planned.plans] == [0, 1, 2]
    assert [p.variant for p in planned.plans] == ["fiber"] * 3
    assert st.plans is None


def _sparse_fit_problem():
    """tests/test_sparse_pallas.py::test_fit_pallas_matches_gather's problem:
    10 % of a non-negative rank-4 CP tensor, all modes non-negative."""
    rng = np.random.default_rng(3)
    shape, R = (60, 50, 40), 4
    facs = [rng.uniform(size=(d, R)) for d in shape]
    dense = np.einsum("ir,jr,kr->ijk", *facs)
    dense[rng.uniform(size=shape) > 0.1] = 0.0
    spec = ProblemSpec(
        mode_sizes=shape,
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN,) * 3)
    data = ProblemData(objects=(JSparseTensor.from_dense(dense),),
                       coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    init = InitOptions(distr=("rand",) * 3, normalize=True,
                       lambdas_init=((1,) * R,))
    return spec, data, init_coupled(spec, data, init, key=0)


def _to_port(spec, data, state):
    return (spec_from_reference(spec),
            data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu"),
            state_from_numpy(state, device="cpu"))


def test_torch_sparse_fit_matches_jax():
    spec, data, state0 = _sparse_fit_problem()
    opts = AlgOptions(MaxOuterIters=25, AbsFuncTol=0.0, OuterRelTol=0.0,
                      sparse_mttkrp="gather")
    st_ref, out_ref = fit(spec, data, state0, opts)
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    assert isinstance(tdata.objects[0], tp.SparseTensor)
    st, out = tfit(tspec, tdata, tstate0, options_from_reference(opts))
    got = state_to_numpy(st)
    for m in range(3):
        np.testing.assert_allclose(got["fac"][m], np.asarray(st_ref.fac[m]),
                                   rtol=1e-10, atol=1e-13)
    for a, b in [(out.func_val_conv, out_ref.func_val_conv),
                 (out.func_coupl_conv, out_ref.func_coupl_conv),
                 (out.func_constr_conv, out_ref.func_constr_conv),
                 (out.func_PAR2_coupl, out_ref.func_PAR2_coupl)]:
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    np.testing.assert_array_equal(out.innerIters, out_ref.innerIters)


def _cp_sparse_golden_problem():
    """tests/test_golden_trajectories.py's "cp_sparse" configuration."""
    spec = ProblemSpec(
        mode_sizes=(12, 13, 14),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, None))
    distr = ["rand", "randn", "randn"]
    data, _, _, _ = create_coupled_data(spec, lambdas=[[1, 1]], noise=0.0,
                                        distr=distr, rng=11)
    data, _ = normalize_data(spec, data)
    X0 = np.array(data.objects[0])
    X0[np.random.default_rng(2).uniform(size=X0.shape) < 0.5] = 0.0
    data = dataclasses.replace(data, objects=(JSparseTensor.from_dense(X0),))
    init = InitOptions(distr=tuple(distr), normalize=True,
                       lambdas_init=((1, 1),))
    return spec, data, init_coupled(spec, data, init, key=7), X0


def test_torch_sparse_fit_reproduces_golden():
    spec, data, state0, _ = _cp_sparse_golden_problem()
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    opts = tp.AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out = tfit(tspec, tdata, tstate0, opts)
    traj = np.stack([out.func_val_conv, out.func_coupl_conv,
                     out.func_constr_conv, out.func_PAR2_coupl])
    want = np.load(os.path.join(GOLDEN_DIR, "cp_sparse.npz"))["traj"]
    # the goldens' own tolerance (tests/test_golden_trajectories.py)
    np.testing.assert_allclose(traj, want, rtol=1e-8, atol=1e-12)


def test_torch_sparse_fit_matches_dense_fit():
    """The same data as a SparseTensor and as a dense tensor give the same
    port fit (tests/test_sparse_stepwise.py's rule, rtol 1e-8)."""
    spec, data, state0, X0 = _cp_sparse_golden_problem()
    tspec, tdata, tstate0 = _to_port(spec, data, state0)
    dense = dataclasses.replace(tdata, objects=(torch.tensor(X0),))
    opts = tp.AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)
    s_sparse, out_sparse = tfit(tspec, tdata, tstate0, opts)
    s_dense, out_dense = tfit(tspec, dense, tstate0, opts)
    np.testing.assert_allclose(out_sparse.func_val_conv, out_dense.func_val_conv,
                               rtol=1e-8, atol=1e-12)
    for m in range(3):
        np.testing.assert_allclose(s_sparse.fac[m].numpy(),
                                   s_dense.fac[m].numpy(), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("sparse", [False, True])
def test_torch_nvecs_init_matches_jax(sparse):
    """nvecs factors (the Gram of each mode's unfolding, dense or through
    the COO Gram) equal the JAX package's init_coupled(nvecs=True)."""
    spec, data, _, X0 = _cp_sparse_golden_problem()
    if not sparse:
        data = dataclasses.replace(data, objects=(jnp.asarray(X0),))
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       nvecs=True, lambdas_init=((1, 1),))
    want = init_coupled(spec, data, init, key=7)
    tdata = data_from_numpy(data.objects, device="cpu")
    assert isinstance(tdata.objects[0], tp.SparseTensor) == sparse
    got = tinit(spec_from_reference(spec), tdata,
                tp.InitOptions(distr=init.distr, normalize=True, nvecs=True,
                               lambdas_init=init.lambdas_init), seed=1)
    for m in range(3):
        np.testing.assert_allclose(got.fac[m].numpy(), np.asarray(want.fac[m]),
                                   rtol=1e-8, atol=1e-12)
    assert got.constraint_fac[0].shape == (12, 2)


def test_torch_check_data_input_refuses_sparse_kl_and_miss():
    st = tp.SparseTensor(torch.zeros((1, 3), dtype=torch.int32),
                         torch.ones(1, dtype=torch.float64))
    spec = tp.ProblemSpec(mode_sizes=(2, 3, 4),
                          datasets=(tp.DatasetSpec("CP", (0, 1, 2), 2,
                                                   loss="KL"),))
    with pytest.raises(ValueError, match="Frobenius"):
        tp.check_data_input(spec, tp.ProblemData(objects=(st,)))
    spec = tp.ProblemSpec(mode_sizes=(2, 3, 4),
                          datasets=(tp.DatasetSpec("CP", (0, 1, 2), 2),))
    miss = torch.ones((2, 3, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="not supported for sparse"):
        tp.check_data_input(spec, tp.ProblemData(objects=(st,), miss=(miss,)))
    tp.check_data_input(spec, tp.ProblemData(objects=(st,)))


def test_torch_sparse_plans_and_devices_on_the_cpu():
    """attach_sparse_plans leaves CPU data as it is; a sparse tensor on
    another device than the factors is refused."""
    spec, data, state0 = _to_port(*_sparse_fit_problem())
    opts = tp.AlgOptions(MaxOuterIters=1, sparse_mttkrp="pallas")
    assert attach_sparse_plans(spec, data, opts) is data
    st = data.objects[0]
    elsewhere = dataclasses.replace(data, objects=(tp.SparseTensor(
        st.indices.to("meta"), st.values.to("meta")),))
    with pytest.raises(ValueError, match="lie on"):
        tfit(spec, elsewhere, state0, opts)


def test_torch_sparse_workload_is_bench_large():
    """utils/sparse_workload.py rebuilds bench_large.sparse_problem without
    jax, draw for draw, at a small D and NNZ."""
    spec_j, data_j, _, opts_j = bench_large.sparse_problem(D=64, NNZ=5000,
                                                           pallas=False)
    spec, data = sparse_workload.build_problem(D=64, NNZ=5000, device="cpu",
                                               dtype=torch.float64)
    assert spec == spec_from_reference(spec_j)
    st, jst = data.objects[0], data_j.objects[0]
    assert st.indices.dtype == torch.int32
    np.testing.assert_array_equal(st.indices.numpy(), np.asarray(jst.indices))
    np.testing.assert_array_equal(st.values.numpy(), np.asarray(jst.values))
    opts = sparse_workload.sparse_options()
    assert (opts.MaxOuterIters, opts.MaxInnerIters) == (
        opts_j.MaxOuterIters, opts_j.MaxInnerIters)
    assert sparse_workload.sparse_init_options().lambdas_init == ((1,) * 16,)
    assert (sparse_workload.D, sparse_workload.NNZ, sparse_workload.R) == (
        2048, 10_000_000, 16)
