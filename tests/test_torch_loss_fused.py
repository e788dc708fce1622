"""The fused evaluation of kernel D (ops/losses.loss_fg_mttkrp: sum fh and
the gh MTTKRP of a dense 3-way dataset in one call) on the CPU, in
float64: its plain version against the JAX package's L-BFGS-B data pass
(matlab_code_tpu/models/lbfgs_bridge.py:44-48: ktensor_full, sum loss_fh,
loss_gh, mttkrp), its start-axis batching rule against per-start calls,
the route lbfgs_bridge and the objective choose, and the kernel's launch
plan.  The kernel itself runs only on the card
(tests/test_torch_loss_fused_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matlab_code_tpu.ops import losses as jlosses
from matlab_code_tpu.ops import tensor as jtensor
from matlab_code_tpu_torch.models import lbfgs_bridge, objective
from matlab_code_tpu_torch.ops import loss_cuda, losses
from matlab_code_tpu_torch.ops.tensor import ktensor_full, mttkrp
from matlab_code_tpu_torch.options import AlgOptions
from matlab_code_tpu_torch.parallel import sharding
from matlab_code_tpu_torch.problem import (
    CouplingSpec, DatasetSpec, ProblemData, ProblemSpec)

EPS_LOG = 1e-10
SHAPE, R = (7, 9, 11), 3


def _problem(seed, shape=SHAPE, rank=R, starts=None):
    """Factors U(0.1, 1.1) (with a leading start axis where `starts`) and
    Poisson counts of their model, as numpy float64."""
    rng = np.random.default_rng(seed)
    lead = () if starts is None else (starts,)
    facs = [rng.uniform(0.1, 1.1, size=lead + (n, rank)) for n in shape]
    M = np.einsum("...ir,...jr,...kr->...ijk", *facs)
    return facs, rng.poisson(M).astype(np.float64)


@pytest.mark.parametrize("loss,beta", [("KL", None), ("IS", None),
                                       ("beta", 0.5), ("beta", 1.5)])
def test_torch_loss_fused_matches_jax_vag(loss, beta):
    """loss_fg_mttkrp (the CPU's route) and its plain version against the
    JAX package's vag data pass in modes 0-2 at rtol 1e-12; the CPU route
    makes the three-call evaluation's operations, so its bits are those of
    ktensor_full, loss_fg and mttkrp; grad=False gives the same f."""
    facs, X = _problem(11)
    tf, tX = [torch.tensor(F) for F in facs], torch.tensor(X)
    jf, jX = [jnp.asarray(F) for F in facs], jnp.asarray(X)
    jM = jtensor.ktensor_full(jf)
    f_jax = np.asarray(jnp.sum(jlosses.loss_fh(loss, jX, jM, EPS_LOG, beta)))
    jY = jlosses.loss_gh(loss, jX, jM, EPS_LOG, beta)
    f_old, Y_old = losses.loss_fg(loss, tX, ktensor_full(tf).contiguous(),
                                  EPS_LOG, beta)
    for mode in range(3):
        g_jax = np.asarray(jtensor.mttkrp(jY, jf, mode))
        f, G = losses.loss_fg_mttkrp(loss, tX, tf, mode, EPS_LOG, beta)
        f_ref, G_ref = losses.loss_fg_mttkrp_reference(loss, tX, tf, mode,
                                                       EPS_LOG, beta)
        assert f.shape == () and G.shape == (SHAPE[mode], R)
        for got_f, got_g in ((f, G), (f_ref, G_ref)):
            np.testing.assert_allclose(got_f.numpy(), f_jax, rtol=1e-12)
            np.testing.assert_allclose(got_g.numpy(), g_jax, rtol=1e-12)
        assert torch.equal(f, f_old)
        assert torch.equal(G, mttkrp(Y_old, tf, mode))
        f_only, none = losses.loss_fg_mttkrp(loss, tX, tf, mode, EPS_LOG,
                                             beta, grad=False)
        assert none is None and torch.equal(f_only, f)


@pytest.mark.parametrize("shared", [True, False])
def test_torch_loss_fused_start_axis_rule(shared):
    """The batching rule of the start-axis operator against one call a
    start, X shared by the starts or one X a start (EM imputation), in
    each mode and without grad: the same bits."""
    S = 3
    facs, X = _problem(12, starts=S)
    tf = [torch.tensor(F) for F in facs]
    tX = torch.tensor(X[0] if shared else X)
    for mode, grad in ((0, True), (1, True), (2, True), (1, False)):
        def one(x, a, b, c):
            return losses._loss_fg_mttkrp_starts(x, [a, b, c], mode, "KL",
                                                 EPS_LOG, None, grad)
        f, G = torch.func.vmap(one, in_dims=(None if shared else 0, 0, 0, 0))(
            tX, *tf)
        assert f.shape == (S,)
        assert G.shape == ((S, SHAPE[mode], R) if grad else (S, 0))
        for s in range(S):
            f1, G1 = losses.loss_fg_mttkrp_reference(
                "KL", tX if shared else tX[s], [F[s] for F in tf], mode,
                EPS_LOG, None, grad)
            assert torch.equal(f[s], f1)
            if grad:
                assert torch.equal(G[s], G1)


class _Route(Exception):
    pass


def test_torch_loss_fused_route_choice(monkeypatch):
    """lbfgs_bridge's evaluation and the objective take loss_fg_mttkrp for
    an uncut dense 3-way dataset and keep ktensor_full + loss_fg for a
    2-way dataset, for a 3-way block cut over a mesh and for a rank past
    FUSED_MAX_RANK (9 and 65 in float64); the spies stop each call at its
    first pass."""
    seen = []

    def spy(name):
        def call(*args, **kwargs):
            seen.append(name)
            raise _Route
        return call

    monkeypatch.setattr(losses, "loss_fg_mttkrp", spy("fused"))
    monkeypatch.setattr(losses, "loss_fg", spy("old"))
    rng = np.random.default_rng(13)
    spec = ProblemSpec(
        mode_sizes=(4, 6, 5, 4, 3),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2, loss="KL"),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, loss="KL")),
        coupling=CouplingSpec(lin_coupled_modes=(0,) * 5, coupling_type=()),
        constraints=(None,) * 5)
    data = ProblemData(objects=(torch.tensor(rng.poisson(2.0, (4, 6, 5)),
                                             dtype=torch.float64),
                                torch.tensor(rng.poisson(2.0, (4, 3)),
                                             dtype=torch.float64)),
                       coupl_trafo=(None,) * 5, coupl_trafo2=(None,) * 5)
    cut = sharding.device_put(data, sharding.data_shardings(
        spec, data, sharding.Mesh(size=2, rank=0))[0])
    assert sharding.dataset_shard(cut, 0).cut
    assert not losses.takes_fused(cut.objects[0], 2, True)
    # the fused route's widest rank is 16 in float32 and 8 in float64
    # (losses.FUSED_MAX_RANK); wider ranks, past the kernel's 64 too, keep
    # the old route, which takes any rank
    X64 = data.objects[0]
    assert losses.takes_fused(X64, 8, False)
    assert not losses.takes_fused(X64, 9, False)
    assert losses.takes_fused(X64.float(), 16, False)
    assert not losses.takes_fused(X64.float(), 17, False)
    assert not losses.takes_fused(X64.half(), 2, False)

    def state(rank):
        class State:
            fac = tuple(torch.tensor(rng.uniform(0.5, 1.5, (n, rank)))
                        for n in spec.mode_sizes)
        return State()

    opts = AlgOptions()
    for d, m, rank, want in ((data, 0, 2, "fused"), (data, 3, 2, "old"),
                             (cut, 1, 2, "old"), (data, 0, 9, "old"),
                             (data, 0, 65, "old")):
        seen.clear()
        step = lbfgs_bridge.make_lbfgs_step(spec, spec.which_p(m), m, opts)
        with pytest.raises(_Route):
            step(state(rank), d, False, -1, 1.0)
        assert seen == [want], (m, rank, seen)
    for d, rank, want in ((data, 2, "fused"), (cut, 2, "old"),
                          (data, 65, "old")):
        seen.clear()
        with pytest.raises(_Route):
            objective.func_eval(spec, d, state(rank), None, (0.0, 0.0), None,
                                options=opts)
        assert seen == [want], (rank, seen)


def test_torch_loss_fused_plan_and_checks():
    """plan_fused: a k tile of whole threads covering K, chunks within the
    shared memory, ranges covering every row once, one partial slice per
    range and k tile; a rank past 64 and an empty X are refused, and the
    wrappers refuse CPU tensors, a loss without a kernel, a missing beta
    and a factor too few before any build."""
    for shape in ((128, 256, 256), (50, 30, 40), (1, 1, 1), (37, 50, 29),
                  (2, 3000, 8), (3, 2, 1100), (1024, 1024, 1)):
        for rank in (1, 3, 8, 16, 40, 64):
            for item in (4, 8):
                for mode in range(3):
                    p = loss_cuda.plan_fused(shape, rank, mode, item)
                    I, J, K = shape
                    assert p.rm >= rank and p.rm in loss_cuda.FUSED_RMS
                    assert p.kpt == loss_cuda.fused_kpt(p.rm, item)
                    tile = p.kpt << p.kw_log2
                    assert p.ktiles == -(-K // tile) and 0 <= p.kw_log2 <= 8
                    assert p.span % p.chunk_rows == 0
                    assert p.smem <= loss_cuda.FUSED_SMEM_MAX
                    assert p.chunk_rows * p.rm <= (loss_cuda.FUSED_THREADS
                                                   * loss_cuda.FUSED_STAGE)
                    rows = (J if mode == 0 else I) if mode < 2 else I * J
                    assert (p.nsplit - 1) * p.span < rows <= p.nsplit * p.span
                    assert p.nout == (I, J, K)[mode]
                    if mode < 2:
                        assert p.units == p.ktiles * p.nsplit * p.nout
                        assert p.nslices == p.ktiles * p.nsplit
                    else:
                        assert p.units == p.ktiles * p.nsplit
                        assert p.nslices == p.nsplit
    with pytest.raises(ValueError, match="rank 65"):
        loss_cuda.plan_fused((4, 4, 4), 65, 0, 4)
    with pytest.raises(ValueError, match="empty"):
        loss_cuda.plan_fused((4, 0, 4), 3, 0, 4)
    facs, X = _problem(14)
    tf, tX = [torch.tensor(F) for F in facs], torch.tensor(X)
    with pytest.raises(ValueError, match="not a CUDA card"):
        loss_cuda.loss_fg_mttkrp_cuda("KL", tX, tf, 0, EPS_LOG)
    with pytest.raises(ValueError, match="no kernel for loss"):
        loss_cuda.loss_fg_mttkrp_cuda("Frobenius", tX, tf, 0, EPS_LOG)
    with pytest.raises(ValueError, match="three factors"):
        loss_cuda.loss_fg_mttkrp_cuda("KL", tX, tf[:2], 0, EPS_LOG)
    with pytest.raises(ValueError, match="beta"):
        loss_cuda.loss_fg_mttkrp_cuda_starts("beta", tX, [F[None] for F in tf],
                                             0, EPS_LOG)
