"""The port's fit_multistart against its own sequential fits, on the CPU in
float64: every start on the start axis against fit (or cmtf_aoadmm) from
the same init state, a stopped start's state and history left as they were
at its stop, the host reads of the batched inner loops, the batched-column
MTTKRP layout and the folded sequential proxes against one call a start,
and the cases not on the start axis.  The JAX package's
fit_multistart is held in test_torch_multistart.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.models import admm
from matlab_code_tpu_torch.models.multistart import _fit_lanes
from matlab_code_tpu_torch.ops.isotonic import project_unimodal
from matlab_code_tpu_torch.ops.prox import t_smoothness_prox
from matlab_code_tpu_torch.ops.tensor import mttkrp, mttkrp_columns
from matlab_code_tpu_torch.ops.tv import prox_tv
from matlab_code_tpu_torch.state import FIELDS
from matlab_code_tpu_torch.utils import em_workload
from matlab_code_tpu_torch.utils import multistart_workload as mw

STREAMS = ("func_val_conv", "func_coupl_conv", "func_constr_conv",
           "func_PAR2_coupl")
NN = tp.ConstraintSpec("non-negativity")


def _par2(config):
    """A small PARAFAC2 problem: ragged slices with a unimodal Bk switched
    on at iteration 3, or regular slices under tPARAFAC2 with ridge."""
    rng = np.random.default_rng(4)
    K, I, R = 5, 9, 2
    sizes = (7, 8, 6, 8, 7) if config == "ragged" else (8,) * K
    A, C = rng.uniform(size=(I, R)), rng.uniform(0.5, 1.5, size=(K, R))
    slices = [A @ np.diag(C[k]) @ rng.uniform(size=(J, R)).T
              + 0.05 * rng.uniform(size=(I, J)) for k, J in enumerate(sizes)]
    X = tp.Parafac2Tensor.from_list(slices, dtype=torch.float64,
                                    device="cpu")
    if config == "ragged":
        Bk, ridge = tp.ConstraintSpec("unimodality", (True,)), None
        opts = tp.AlgOptions(MaxOuterIters=6, AbsFuncTol=0.0, OuterRelTol=0.0,
                             iter_start_PAR2Bkconstraint=3)
    else:
        Bk, ridge = tp.ConstraintSpec("tPARAFAC2", (10.0,)), (0.1, 0.0, 0.1)
        opts = tp.AlgOptions(MaxOuterIters=5, AbsFuncTol=0.0, OuterRelTol=0.0)
    spec = tp.ProblemSpec(
        mode_sizes=(I, sizes, K),
        datasets=(tp.DatasetSpec("PAR2", (0, 1, 2), R),),
        constraints=(NN, Bk, NN), ridge=ridge)
    data = tp.ProblemData(objects=(X,), coupl_trafo=(None,) * 3,
                          coupl_trafo2=(None,) * 3)
    return spec, data, opts, tp.InitOptions(distr=("rand",) * 3)


def _cp():
    """A noiseless 8 x 9 x 10 rank-2 CP tensor, mode 0 non-negative (the
    problem of tests/test_aux.py, drawn here): its starts stop at their
    own iterations."""
    rng = np.random.default_rng(3)
    X = np.einsum("ir,jr,kr->ijk", rng.uniform(size=(8, 2)),
                  rng.standard_normal((9, 2)), rng.standard_normal((10, 2)))
    spec = tp.ProblemSpec(mode_sizes=(8, 9, 10),
                          datasets=(tp.DatasetSpec("CP", (0, 1, 2), 2),),
                          constraints=(NN, None, None))
    data = tp.ProblemData(objects=(torch.tensor(X / np.linalg.norm(X)),),
                          coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    opts = tp.AlgOptions(MaxOuterIters=60, AbsFuncTol=1e-10, OuterRelTol=1e-9)
    return spec, data, opts, tp.InitOptions(distr=("rand", "randn", "randn"),
                                            normalize=True)


def _problem(case):
    if case == "script15":
        spec, data, opts, init = mw.script15_problem("cpu", torch.float64)
        opts = dataclasses.replace(opts, MaxOuterIters=12)
    elif case == "em":
        spec, data, opts, init = em_workload.script12_problem("cpu",
                                                              torch.float64)
        opts = dataclasses.replace(opts, MaxOuterIters=8)
    else:
        spec, data, opts, init = _par2(case)
    return spec, data, opts, init


def _hold_lane(out, st, ref, ref_st):
    assert out.OuterIterations == ref.OuterIterations
    assert out.exit_flag == ref.exit_flag
    np.testing.assert_array_equal(out.innerIters, ref.innerIters)
    for s in STREAMS:
        np.testing.assert_allclose(getattr(out, s), getattr(ref, s),
                                   rtol=1e-10, atol=1e-15, err_msg=s)
    if ref.func_rel_missing is not None:
        np.testing.assert_allclose(out.func_rel_missing, ref.func_rel_missing,
                                   rtol=1e-10, atol=1e-15)
    for m, (a, b) in enumerate(zip(st.fac, ref_st.fac)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-13, err_msg=f"mode {m}")


@pytest.mark.parametrize("case", ["script15", "ragged", "tparafac2", "em"])
def test_torch_multistart_every_lane_matches_its_fit(case):
    """Every start against the port's fit from the same init state: the
    same exit iteration, exit_flag and innerIters, streams and factors at
    rtol 1e-10.  Script 15's widths (type 4, non-negative, 12 outer
    iterations), ragged PARAFAC2 slices with the unimodal Bk
    constraint switched on at iteration 3, tPARAFAC2 (kernel C's plain
    version a start), and script 12's EM problem (each start imputing its
    own data)."""
    spec, data, opts, init = _problem(case)
    states = [tp.init_coupled(spec, data, init, seed=k) for k in range(3)]
    lanes = _fit_lanes(spec, data, states, opts)
    for s, st0 in enumerate(states):
        ref_st, ref = tp.fit(spec, data, st0, opts)
        _hold_lane(lanes.outs[s], lanes.state(s), ref, ref_st)


def test_torch_multistart_keys_are_sequential_seeds():
    """fit_multistart(keys=...) at script 15's widths (its options, 20
    outer iterations) against sequential cmtf_aoadmm(..., seed=k): every
    final f_tensors, and the best start's output and state; without keys,
    start s takes the seed base_key + s."""
    spec, data, opts, init = mw.script15_problem("cpu", torch.float64)
    opts = dataclasses.replace(opts, MaxOuterIters=20)
    keys = [3, 11, 7]
    best_st, best, finals, stops = tp.fit_multistart(
        spec, data, opts, init, 3, keys=keys)
    refs = [tp.cmtf_aoadmm(spec, data, opts, init_options=init, seed=k)
            for k in keys]
    np.testing.assert_allclose(finals, [r[3].f_tensors for r in refs],
                               rtol=1e-10)
    assert stops == [r[3].OuterIterations for r in refs]
    b = int(np.argmin(finals))
    _hold_lane(best, best_st, refs[b][3], refs[b][1])
    assert best.time_at_it.shape == (best.OuterIterations + 1,)
    _, _, finals2, _ = tp.fit_multistart(
        spec, data, dataclasses.replace(opts, MaxOuterIters=2), init, 2,
        base_key=11)
    _, _, finals3, _ = tp.fit_multistart(
        spec, data, dataclasses.replace(opts, MaxOuterIters=2), init, 2,
        keys=[11, 12])
    np.testing.assert_array_equal(finals2, finals3)


def test_torch_multistart_frozen_lane_and_host_reads():
    """A start that stopped keeps its state and history bit for bit while
    the others go on (against a run that ends at its stop), and the reads
    of an iteration do not grow with the starts: one outer read, and one
    read a step of each inner loop while any start still steps (the
    slowest start's count, at most MaxInnerIters - 1 a loop)."""
    spec, data, opts, init = _cp()
    states = [tp.init_coupled(spec, data, init, seed=k) for k in range(4)]
    admm.to_host.calls = 0
    lanes = _fit_lanes(spec, data, states, opts)
    reads = admm.to_host.calls
    stops = [o.OuterIterations for o in lanes.outs]
    first = int(np.argmin(stops))
    assert stops[first] < max(stops)
    early = _fit_lanes(spec, data, states, dataclasses.replace(
        opts, MaxOuterIters=stops[first]))
    a, b = lanes.state(first), early.state(first)
    for f in FIELDS:
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert (x is None and y is None) or torch.equal(x, y)
    for s in STREAMS:
        np.testing.assert_array_equal(getattr(lanes.outs[first], s),
                                      getattr(early.outs[first], s))
    loops = (0,)          # the one constrained mode's loop
    want = 0
    for it in range(1, max(stops) + 1):
        live = [o for o in lanes.outs if o.OuterIterations >= it]
        want += 1 + sum(min(max(o.innerIters[m, it] for o in live),
                            opts.MaxInnerIters - 1) for m in loops)
    assert reads == want
    assert reads <= max(stops) * (1 + len(loops) * (opts.MaxInnerIters - 1))


def test_torch_mttkrp_columns_and_folded_proxes_match_one_call_a_start():
    """The starts' MTTKRPs as one call with their columns side by side
    (column s*R + r is start s's column r), under the vmap of the start
    axis and by mttkrp_columns, and with X carrying the start axis, against
    one mttkrp a start; the unimodal (ragged too), TV and tPARAFAC2 proxes
    on the start axis against one call a start (bit for bit: the plain
    walks run column by column)."""
    g = torch.Generator().manual_seed(0)
    S, R, shape = 3, 4, (5, 6, 7)
    X = torch.rand(shape, generator=g, dtype=torch.float64)
    Xs = torch.rand((S,) + shape, generator=g, dtype=torch.float64)
    F = [torch.rand((S, n, R), generator=g, dtype=torch.float64)
         for n in shape]
    for mode in range(3):
        want = torch.stack([mttkrp(X, [f[s] for f in F], mode)
                            for s in range(S)])
        wide = [f.transpose(0, 1).reshape(f.shape[1], S * R) for f in F]
        np.testing.assert_array_equal(wide[1][:, R + 2].numpy(),
                                      F[1][1, :, 2].numpy())
        for got in (mttkrp_columns(X, F, mode),
                    torch.func.vmap(lambda a, b, c: mttkrp(
                        X, [a, b, c], mode))(*F)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-13)
        got = torch.func.vmap(lambda x, a, b, c: mttkrp(x, [a, b, c], mode))(
            Xs, *F)
        np.testing.assert_allclose(got.numpy(), torch.stack([
            mttkrp(Xs[s], [f[s] for f in F], mode) for s in range(S)]).numpy(),
            rtol=1e-13)
    V = torch.randn((S, 4, 9, 3), generator=g, dtype=torch.float64)
    rho = torch.rand((S, 4), generator=g, dtype=torch.float64) + 0.5
    sizes = (9, 6, 8, 7)
    checks = [
        (lambda v: project_unimodal(v, True), (V,)),
        (lambda v: project_unimodal(v, False, sizes), (V,)),
        (lambda v, r: prox_tv(v, 0.1 / r[:, None, None]), (V, rho)),
        (lambda v, r: prox_tv(v[0], 0.1 / r[0]), (V, rho)),
        (lambda v, r: t_smoothness_prox(v, r, 2.0), (V, rho)),
    ]
    for fn, args in checks:
        got = torch.func.vmap(fn)(*args)
        want = torch.stack([fn(*(a[s] for a in args)) for s in range(S)])
        assert torch.equal(got, want)


def test_torch_multistart_cases_not_reached_raise():
    """mesh= raises NotImplementedError naming its ROADMAP slice, and a
    wrong number of keys raises ValueError.  matmul_precision='bfloat16'
    runs on the CPU with 'default''s bits (it raises only on a card), and
    the switches of torch's TF32 stay as they were.  Other losses, sparse
    COO data and the pairwise option run on the start axis
    (tests/test_torch_multistart_{kl,nonfrob,sparse,repairs}.py)."""
    spec, data, opts, init = mw.script15_problem("cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="slice 8"):
        tp.fit_multistart(spec, data, opts, init, 2, mesh=object())
    with pytest.raises(ValueError, match="keys"):
        tp.fit_multistart(spec, data, opts, init, 2, keys=[1])
    saved = torch.backends.cuda.matmul.allow_tf32
    short = dataclasses.replace(opts, MaxOuterIters=2)
    _, _, bf16, _ = tp.fit_multistart(spec, data, dataclasses.replace(
        short, matmul_precision="bfloat16"), init, 2)
    _, _, plain, _ = tp.fit_multistart(spec, data, short, init, 2)
    np.testing.assert_array_equal(bf16, plain)
    assert torch.backends.cuda.matmul.allow_tf32 is saved
