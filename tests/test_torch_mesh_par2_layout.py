"""The PARAFAC2 K-cut layout of the port (matlab_code_tpu_torch/parallel/
sharding.py) against the JAX package's: data_shardings cuts a PARAFAC2
dataset's slices, column mask and missing-data mask along K where the mesh
size divides K, and state_shardings its Bk factor (with the Bk constraint
and dual factors), P and mu_DeltaB, on 2 and 4 ranks; the port keeps C
replicated where the JAX package cuts it.  The blocks concatenate back to
the full data and state, and a state cut already is not cut again.  On 4
gloo ranks: globalize and fetch round trips of the data and the state,
and a coupled CP + PARAFAC2 fit with K = 8 (two slices a rank) against the
port's plain fit and the JAX package's fit(mesh=make_mesh(4))."""
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matlab_code_tpu.parallel import sharding as jsh
from matlab_code_tpu_torch import convert
from matlab_code_tpu_torch.parallel import sharding as tsh
from matlab_code_tpu_torch.state import FIELDS

import torch_mesh_cases as mc

RUNTIME = ("regular", "c_type1", "em")


def _problems():
    """(name, JAX spec, data, state): K = 8, 6 and 5 (cut on 2 and 4, on
    2 only, on neither), ragged and with missing entries."""
    return {"regular": mc.par2_regular(), "k6": mc.par2_regular(K=6),
            "k5": mc.par2_regular(K=5), "ragged": mc.par2_ragged(),
            "c_type1": mc.par2_c_type1(), "em": mc.par2_em()}


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, problems):
    spec, data, state, _ = ge._flagship(I0=16, J1=12, J2=16, K=8, Jb=10, R=3)
    tasks = [("runtime", k, mc.payload(*problems[k])) for k in RUNTIME]
    tasks.append(("fit", "flagship", mc.payload(spec, data, state)))
    ranks = mc.start_ranks(tmp_path_factory.mktemp("par2_layout"), tasks,
                           n=4)
    want = mc.jax_mesh_fit(spec, data, state, n=4)
    return ranks.results(), want


def _axis(sh):
    """The axis a JAX NamedSharding or a port Shard cuts, or None."""
    if isinstance(sh, tsh.Shard):
        return sh.axis
    spec = tuple(sh.spec)
    return spec.index(jsh.DATA_AXIS) if jsh.DATA_AXIS in spec else None


def _port(spec, data, state):
    p = mc.payload(spec, data, state)
    return (p["spec"], convert.data_from_numpy(
        p["objects"], p["coupl_trafo"], p["coupl_trafo2"], p["miss"],
        device="cpu"), convert.state_from_numpy(p["state"], device="cpu"))


@pytest.mark.parametrize("n", (2, 4))
def test_torch_mesh_par2_layout_matches_jax(n, problems):
    jmesh, tmesh = jsh.make_mesh(n), tsh.Mesh(size=n)
    for name, (spec, data, state) in problems.items():
        tspec, tdata, tstate = _port(spec, data, state)
        jlay, jmodes = jsh.data_shardings(spec, data, jmesh)
        tlay, tmodes = tsh.data_shardings(tspec, tdata, tmesh)
        assert tmodes == jmodes, name
        for p, ds in enumerate(spec.datasets):
            j, t = jlay.objects[p], tlay.objects[p]
            if ds.model == "PAR2":
                K = spec.mode_sizes[ds.modes[2]]
                assert _axis(t.slices) == _axis(j.slices) == (
                    0 if K % n == 0 else None), (name, n)
                assert _axis(t.mask) == _axis(j.mask), (name, n)
            if data.miss[p] is not None:
                assert _axis(tlay.miss[p]) == _axis(jlay.miss[p]), name
        jst = jsh.state_shardings(spec, state, jmesh, jmodes)
        tst = tsh.state_shardings(tspec, tstate, tmesh, tmodes)
        for k in FIELDS:
            for i, (a, b) in enumerate(zip(getattr(tst, k), getattr(jst, k))):
                assert (a is None) == (b is None), (name, k, i)
                if a is None:
                    continue
                if k in ("fac", "constraint_fac", "constraint_dual_fac") \
                        and tspec.mode_role(i) == "par2_C":
                    # C stays replicated in the port
                    assert _axis(a) is None
                    continue
                assert _axis(a) == _axis(b), (name, k, i)


@pytest.mark.parametrize("n", (2, 4))
def test_torch_mesh_par2_blocks_concatenate(n, problems):
    """Each rank's blocks of the data (lay_out) and of the state
    concatenate back to the full values along K; replicated leaves come
    whole; lay_out of laid-out data and a cut state keeps the blocks."""
    for name, (spec, data, state) in problems.items():
        tspec, tdata, tstate = _port(spec, data, state)
        laid = [tsh.lay_out(tspec, tdata, tstate, tsh.Mesh(size=n, rank=r))
                for r in range(n)]
        cut = tsh.par2_cut_modes(tspec, laid[0][0])
        for p, X in enumerate(tdata.objects):
            if not hasattr(X, "slices"):
                continue
            sh = tsh.dataset_shard(laid[0][0], p)
            assert sh.cut == (X.slices.shape[0] % n == 0), name
            cat = (lambda xs: torch.cat(xs)) if sh.cut else \
                (lambda xs: xs[0])
            for part in ("slices", "mask"):
                assert torch.equal(cat([getattr(d.objects[p], part)
                                        for d, _ in laid]),
                                   getattr(X, part)), (name, part)
            if tdata.miss[p] is not None:
                assert torch.equal(cat([d.miss[p] for d, _ in laid]),
                                   tdata.miss[p])
        sts = tsh.state_shardings(tspec, tstate, tsh.Mesh(size=n), cut)
        for k in FIELDS:
            for i, full in enumerate(getattr(tstate, k)):
                if full is None:
                    continue
                parts = [getattr(st, k)[i] for _, st in laid]
                if getattr(sts, k)[i].axis is None:
                    assert all(torch.equal(q, full) for q in parts)
                else:
                    assert all(q.shape[0] == full.shape[0] // n
                               for q in parts)
                    assert torch.equal(torch.cat(parts), full), (name, k, i)
        # a second lay_out of this rank's data and state changes nothing
        d1, s1 = laid[-1]
        d2, s2 = tsh.lay_out(tspec, d1, s1, tsh.Mesh(size=n, rank=n - 1))
        assert d2 is d1
        assert all(a is b or torch.equal(a, b) for k in FIELDS
                   for a, b in zip(getattr(s2, k), getattr(s1, k))
                   if a is not None)


def test_torch_mesh_par2_fetch_round_trips(four_ranks, problems):
    """globalize_tree and fetch_tree of the data and the state on 4 ranks:
    the K = 8 datasets' cut leaves hold 2 slices a rank, the K = 6
    dataset (not divisible by 4) stays whole; the fetched trees equal the
    full ones; the globalized fit's ranks hold the same bits."""
    ranks, _ = four_ranks
    for res in ranks:
        for k in RUNTIME:
            got = res[k]
            assert got["round_trip"] and got["agree"], k
            spec = problems[k][0]
            p = [ds.model for ds in spec.datasets].index("PAR2")
            mB = spec.datasets[p].modes[1]
            K = spec.mode_sizes[spec.datasets[p].modes[2]]
            rows = K // 4 if K % 4 == 0 else K
            assert got["block_rows"]["fac"][mB] == rows, k
            assert got["block_rows"]["P"][p] == rows, k
            assert got["block_rows"]["fac"][spec.datasets[p].modes[2]] == K
            np.testing.assert_array_equal(got["fac"][mB],
                                          ranks[0][k]["fac"][mB])


def test_torch_mesh_par2_fit_four_ranks(four_ranks):
    """tests/test_aux.py::test_sharded_full_fit_matches_single_device's
    problem (CP coupled with PARAFAC2, K = 8) on 4 ranks, two slices
    a rank, at tests/test_mesh_coupled.py's tolerances."""
    ranks, (st, out) = four_ranks
    r0 = mc.check_fit(ranks, "flagship", out, st)
    assert r0["layout"] == {0: 0, 1: 0}


def test_torch_mesh_par2_layout_choices_and_uncut_shard(problems):
    """data_shardings' par2 choices: 'replicated' replicates every PARAFAC2
    dataset and marks none of its modes, and cuts every other dataset as
    'auto' does; 'auto' replicates a tPARAFAC2 dataset, which 'cut' cuts as
    the JAX function does.  The Shard of a replicated dataset, and UNCUT
    of full data, return their input from rows, local_factors, psum and
    gather."""
    mesh = tsh.Mesh(size=2, rank=1)
    for name, (spec, data, state) in problems.items():
        tspec, tdata, tstate = _port(spec, data, state)
        cut, cut_modes = tsh.data_shardings(tspec, tdata, mesh)
        rep, rep_modes = tsh.data_shardings(tspec, tdata, mesh,
                                            par2="replicated")
        par2 = {m for ds in tspec.datasets if ds.model == "PAR2"
                for m in ds.modes}
        assert rep_modes == {m: v for m, v in cut_modes.items()
                             if m not in par2}, name
        laid = tsh.device_put(tdata, rep)
        for p, ds in enumerate(tspec.datasets):
            sh = tsh.dataset_shard(laid, p)
            if ds.model == "PAR2":
                assert not sh.cut and sh.mesh is mesh, name
                assert laid.objects[p].slices is tdata.objects[p].slices
            else:
                assert _axis(sh) == _axis(cut.objects[p]), name
            assert tsh.dataset_shard(tdata, p) is tsh.UNCUT
        _, st = tsh.lay_out(tspec, laid, tstate, mesh)
        assert all(torch.equal(a, b) for a, b in zip(st.fac, tstate.fac))
    spec, data, state = mc.par2_tpar2()
    tspec, tdata, _ = _port(spec, data, state)
    jlay, jmodes = jsh.data_shardings(spec, data, jsh.make_mesh(2))
    auto, auto_modes = tsh.data_shardings(tspec, tdata, mesh)
    assert _axis(auto.objects[0].slices) is None and auto_modes == {}
    lay, modes = tsh.data_shardings(tspec, tdata, mesh, par2="cut")
    assert modes == jmodes and _axis(lay.objects[0].slices) == 0 == _axis(
        jlay.objects[0].slices)
    with pytest.raises(ValueError, match="par2="):
        tsh.data_shardings(tspec, tdata, mesh, par2="rows")
    U = torch.arange(12.0).reshape(4, 3)
    for sh in (tsh.UNCUT, tsh.Shard(mesh)):
        assert sh.rows(U) is U and sh.psum(U) is U and sh.gather(U) is U
        assert all(a is b for a, b in zip(sh.local_factors([U, U]), [U, U]))
