"""fit_multistart(mesh=) of the port on 2 gloo ranks: the start axis
shared out over the ranks (6 starts, 3 a rank), the data replicated, one
gather at the end.  Against the port's unsharded fit_multistart with the
same keys (finals and the best start's stream rtol 1e-10, stop iterations
equal) and, from the JAX package's init states, against the JAX
fit_multistart(mesh=make_mesh(2)); every rank returns the same result; a
start count the mesh size does not divide raises ValueError.
tests/test_mesh_coupled.py::test_mesh_multistart_start_sharded's
problem."""
import numpy as np
import pytest

import matlab_code_tpu_torch as tp
import torch_mesh_cases as mc
from matlab_code_tpu import (
    AlgOptions, CouplingSpec, DatasetSpec, InitOptions, ProblemSpec)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.multistart import fit_multistart

S = 6
KEYS = list(range(S))
OPTS = AlgOptions(MaxOuterIters=60, AbsFuncTol=1e-10, OuterRelTol=1e-9)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    spec = ProblemSpec(
        mode_sizes=(10, 12, 9),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(mc.NN, None, None))
    data, _, _ = mc.build(spec, [[1, 1]], ["rand", "randn", "randn"])
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1),))
    states = [mc.payload(spec, data, init_coupled(spec, data, init, key=k)
                         )["state"] for k in KEYS]
    ranks = mc.start_ranks(tmp_path_factory.mktemp("multistart"), [(
        "multistart", "ms", mc.payload(
            spec, data, options=OPTS, n_starts=S, keys=KEYS, states=states,
            init_options=tp.InitOptions(distr=init.distr, normalize=True,
                                        lambdas_init=init.lambdas_init)))])
    want = fit_multistart(spec, data, OPTS, init, n_starts=S, keys=KEYS,
                          mesh=mc.make_mesh(mc.N))
    return [r["ms"] for r in ranks.results()], want


def _same(a, b, rtol):
    assert a["stops"] == b["stops"]
    np.testing.assert_allclose(a["finals"], b["finals"], rtol=rtol,
                               atol=1e-13)
    np.testing.assert_allclose(a["f"], b["f"], rtol=rtol, atol=1e-13)
    np.testing.assert_array_equal(a["inner"], b["inner"])
    for x, y in zip(a["fac"], b["fac"]):
        np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-11)


def test_torch_mesh_multistart_matches_unsharded(runs):
    ranks, _ = runs
    for res in ranks:
        _same(res["mesh"], res["plain"], rtol=1e-10)


def test_torch_mesh_multistart_same_on_every_rank(runs):
    ranks, _ = runs
    for res in ranks[1:]:
        for key in ("mesh", "lanes_mesh"):
            assert res[key]["stops"] == ranks[0][key]["stops"]
            np.testing.assert_array_equal(res[key]["finals"],
                                          ranks[0][key]["finals"])
            for x, y in zip(res[key]["fac"], ranks[0][key]["fac"]):
                np.testing.assert_array_equal(x, y)


def test_torch_mesh_multistart_matches_jax(runs):
    """From the JAX package's init states: every start's final, stop
    iteration and the best start against the JAX fit_multistart(mesh=)."""
    ranks, (st, out, finals, stops) = runs
    got = ranks[0]["lanes_mesh"]
    assert got["stops"] == [int(s) for s in stops]
    np.testing.assert_allclose(got["finals"], finals, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got["f"], np.asarray(out.func_val_conv),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_array_equal(got["inner"], np.asarray(out.innerIters))
    for m, x in enumerate(got["fac"]):
        np.testing.assert_allclose(x, np.asarray(st.fac[m]), rtol=1e-9,
                                   atol=1e-11)


def test_torch_mesh_multistart_one_gather_and_divisibility(runs):
    """No collective while the starts run: one gather at the end; 7 starts
    on 2 ranks raise ValueError."""
    ranks, _ = runs
    for res in ranks:
        assert res["mesh"]["counts"] == {"psum": 0, "all_gather": 0,
                                         "ring": 0, "gather_object": 1}
        assert res["raised"] and "divisible" in res["raised"]
