"""The port's multi-process runtime (matlab_code_tpu_torch/parallel/
distributed.py) on 2 gloo ranks joined through torchrun's environment
variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE): initialize,
make_global_mesh, globalize and fetch round-trip, and
tests/test_distributed.py's two configurations ('flagship': CP and
PARAFAC2 coupled by type 0; 'type4': the bench flagship's selector
coupling) globalized and fitted without mesh= (the blocks carry their
layout), against the single-process port fit in this process: trajectory
rtol 1e-11, factors rtol 1e-9, every rank's state bit-equal."""
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import matlab_code_tpu_torch as tp
import torch_mesh_cases as mc
from matlab_code_tpu import AlgOptions
from matlab_code_tpu_torch import convert

torch.set_num_threads(1)

OPTS = AlgOptions(MaxOuterIters=40, AbsFuncTol=0.0, OuterRelTol=0.0)


def _problems():
    spec, data, state, _ = ge._flagship(I0=16, J1=12, J2=16, K=8, Jb=10, R=3)
    return {"flagship": (spec, data, state),
            "type4": ge._type4_problem(8)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    problems = _problems()
    ranks = mc.start_ranks(tmp_path_factory.mktemp("runtime"), [
        ("runtime", k, mc.payload(*pr, options=OPTS))
        for k, pr in problems.items()], env_init=True)
    want = {}
    for k, (spec, data, state) in problems.items():
        p = mc.payload(spec, data, state)
        tdata = convert.data_from_numpy(p["objects"], p["coupl_trafo"],
                                        p["coupl_trafo2"], device="cpu")
        st, out = tp.fit(p["spec"], tdata,
                         convert.state_from_numpy(p["state"], device="cpu"),
                         convert.options_from_reference(OPTS))
        want[k] = (st, out)
    return ranks.results(), want


def test_torch_mesh_runtime_globalize_fetch_round_trip(runs):
    ranks, _ = runs
    for res in ranks:
        assert all(res[k]["round_trip"] for k in ("flagship", "type4"))


@pytest.mark.parametrize("config", ["flagship", "type4"])
def test_torch_mesh_runtime_fit_matches_single_process(runs, config):
    ranks, want = runs
    st, out = want[config]
    for res in ranks:
        got = res[config]
        assert got["agree"] and got["sharded"]
        assert got["iters"] == out.OuterIterations
        np.testing.assert_allclose(got["f"], out.func_val_conv, rtol=1e-11,
                                   atol=1e-13)
        np.testing.assert_allclose(got["fc"], out.func_coupl_conv, rtol=1e-9,
                                   atol=1e-12)
        for m, a in enumerate(got["fac"]):
            np.testing.assert_allclose(a, st.fac[m].numpy(), rtol=1e-9,
                                       atol=1e-11)
            np.testing.assert_array_equal(a, ranks[0][config]["fac"][m])
