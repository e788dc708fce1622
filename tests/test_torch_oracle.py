"""The port's fit against the independent numpy oracle (tests/oracle.py),
as tests/test_oracle_parity.py holds the JAX package to it: the coupled
CP case (type 0) and the type-4 selector coupling, with the same data,
init and tolerances."""
import numpy as np

from matlab_code_tpu import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions,
    InitOptions)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data
from tests.oracle import OracleCMTF, OracleCoupledH

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import (
    data_from_numpy, spec_from_reference, state_from_numpy, state_to_numpy)
from matlab_code_tpu_torch.models.solver import compute_znorm_consts


def _fit_port(spec, data, state0, T):
    tspec = spec_from_reference(spec)
    tdata = data_from_numpy(data.objects, data.coupl_trafo, data.coupl_trafo2,
                            device="cpu")
    opts = tp.AlgOptions(MaxOuterIters=T, AbsFuncTol=0.0, OuterRelTol=0.0)
    state, out = tp.fit(tspec, tdata, state_from_numpy(state0, device="cpu"),
                        opts)
    znorms = [float(z) for z in compute_znorm_consts(tspec, tdata, opts)]
    return state_to_numpy(state)["fac"], out, znorms


def _oracle_traj(orc, znorms, T):
    traj = []
    for _ in range(T):
        orc.sweep(AlgOptions(MaxOuterIters=T, AbsFuncTol=0.0, OuterRelTol=0.0))
        traj.append(orc.objective(znorms))
    return np.asarray(traj)


def test_torch_oracle_parity_coupled_cp():
    spec = ProblemSpec(
        mode_sizes=(8, 9, 10, 8, 11),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2, weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=(ConstraintSpec("non-negativity"), None,
                     ConstraintSpec("non-negativity"),
                     ConstraintSpec("non-negativity"), None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1], [1, 1]], noise=0.05,
        distr=["rand", "randn", "rand", "rand", "randn"], rng=6)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "rand", "rand", "randn"),
                       normalize=True, lambdas_init=((1, 1), (1, 1)))
    state0 = init_coupled(spec, data, init, key=5)
    T = 15
    fac, out, znorms = _fit_port(spec, data, state0, T)
    orc = OracleCMTF(
        Xs=[np.asarray(data.objects[0]), np.asarray(data.objects[1])],
        modes=[(0, 1, 2), (3, 4)], weights=[0.5, 0.5],
        constrained={0, 2, 3}, coupled_modes=(0, 3), state=state0)
    traj = _oracle_traj(orc, znorms, T)
    np.testing.assert_allclose(out.func_val_conv[1:], traj[:, 0],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out.func_coupl_conv[1:], traj[:, 1],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out.func_constr_conv[1:], traj[:, 2],
                               rtol=1e-8, atol=1e-12)
    for m in range(5):
        np.testing.assert_allclose(fac[m], orc.fac[m], rtol=1e-8, atol=1e-10)


def test_torch_oracle_parity_type4():
    Hs = {0: np.eye(2, 2), 3: np.eye(2, 2)}
    spec = ProblemSpec(
        mode_sizes=(10, 7, 8, 10, 9),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2, weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(ConstraintSpec("non-negativity"), None, None,
                     ConstraintSpec("non-negativity"), None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1], [1, 1]], noise=0.05,
        distr=["rand", "randn", "randn", "rand", "randn"],
        coupl_trafo=[Hs.get(m) for m in range(5)], rng=6)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=("rand", "randn", "randn", "rand", "randn"),
                       normalize=True, lambdas_init=((1, 1), (1, 1)))
    state0 = init_coupled(spec, data, init, key=5)
    T = 12
    fac, out, znorms = _fit_port(spec, data, state0, T)
    orc = OracleCoupledH(
        Xs=[np.asarray(data.objects[0]), np.asarray(data.objects[1])],
        modes=[(0, 1, 2), (3, 4)], weights=[0.5, 0.5], ctype=4,
        Hs=Hs, constrained={0, 3}, state=state0)
    traj = _oracle_traj(orc, znorms, T)
    np.testing.assert_allclose(out.func_val_conv[1:], traj[:, 0],
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(out.func_coupl_conv[1:], traj[:, 1],
                               rtol=1e-7, atol=1e-11)
    for m in range(5):
        np.testing.assert_allclose(fac[m], orc.base.fac[m], rtol=1e-7,
                                   atol=1e-9)
