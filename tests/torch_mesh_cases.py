"""Helpers of the port's mesh tests (tests/test_torch_mesh_*.py): the
problems (built with the JAX package, crossing as numpy arrays), the JAX
package's mesh fits on make_mesh(n) of this process's virtual devices,
and the port's ranks, run as separate OS processes (tests/torch_mesh_worker.py,
jax-free) over a gloo group.

A test file starts its ranks once (start_ranks), computes the JAX side
while they run, and reads their results (Ranks.results) in a
module-scoped fixture."""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from matlab_code_tpu import (
    AlgOptions, ConstraintSpec, CouplingSpec, DatasetSpec, InitOptions,
    ProblemSpec)
from matlab_code_tpu.models.init import init_coupled
from matlab_code_tpu.models.solver import fit
from matlab_code_tpu.parallel.sharding import (
    data_shardings, make_mesh, state_shardings)
from matlab_code_tpu.problem import SparseTensor
from matlab_code_tpu.utils.datagen import create_coupled_data, normalize_data
from matlab_code_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
N = 2                        # ranks, and the JAX mesh's devices
OPTS = AlgOptions(MaxOuterIters=20, AbsFuncTol=0.0, OuterRelTol=0.0)
NN = ConstraintSpec("non-negativity")
RANKS_TIMEOUT = 400


# ---------------------------------------------------------------- ranks

def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Ranks:
    """n worker processes of one job; results() waits for them and returns
    every rank's {name: result}."""

    def __init__(self, tmp, tasks, n, env_init):
        self.tmp, self.n = tmp, n
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"tasks": tasks}, f)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        if env_init:
            init = "env"
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                       WORLD_SIZE=str(n))
        else:
            init = "file://" + os.path.join(tmp, "store")
        self.logs = [os.path.join(tmp, f"rank{r}.log") for r in range(n)]
        self.outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        self.procs = []
        # output goes to files, not pipes: a blocked pipe would stall one
        # rank inside a collective and hang its peers too
        for r in range(n):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, WORKER, job, str(r), str(n), init,
                     self.outs[r]],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT))

    def results(self):
        try:
            for p in self.procs:
                p.wait(timeout=RANKS_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            pytest.fail("mesh ranks timed out:\n" + self._logs())
        for r, p in enumerate(self.procs):
            log = open(self.logs[r]).read()
            assert p.returncode == 0, f"rank {r} failed:\n{log}"
            assert f"rank {r}: MESHOK" in log, log
        out = []
        for path in self.outs:
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out

    def _logs(self):
        return "\n".join(open(p).read() for p in self.logs)


def start_ranks(tmp, tasks, n=N, env_init=False):
    return Ranks(str(tmp), tasks, n, env_init)


# ------------------------------------------------------------- problems

def _array(a):
    return None if a is None else np.asarray(a)


def numpy_object(X):
    """A JAX-package dataset as what convert.data_from_numpy reads."""
    if isinstance(X, SparseTensor):
        return types.SimpleNamespace(indices=np.asarray(X.indices),
                                     values=np.asarray(X.values))
    if hasattr(X, "slices"):
        return types.SimpleNamespace(slices=np.asarray(X.slices),
                                     mask=np.asarray(X.mask))
    return np.asarray(X)


def payload(spec, data, state=None, options=OPTS, **extra):
    """A worker task's problem: the port's spec and options, the data and
    the init state as numpy."""
    out = dict(spec=convert.spec_from_reference(spec),
               options=convert.options_from_reference(options),
               objects=[numpy_object(X) for X in data.objects],
               miss=[_array(m) for m in data.miss],
               coupl_trafo=[_array(H) for H in data.coupl_trafo],
               coupl_trafo2=[_array(H) for H in data.coupl_trafo2], **extra)
    if state is not None:
        out["state"] = {k: tuple(_array(a) for a in getattr(state, k))
                        for k in ("fac", "constraint_fac",
                                  "constraint_dual_fac", "coupling_fac",
                                  "coupling_dual_fac", "P", "DeltaB",
                                  "mu_DeltaB")}
    return out


def build(spec, lambdas, distr, coupl_trafo=None, coupl_trafo2=None, key=1,
          data_rng=7, delta_shapes=None, bk_style="orth", noise=0.02):
    """tests/test_mesh_coupled.py's _build: data, normalized, and an init."""
    data, _, _, _ = create_coupled_data(
        spec, lambdas=lambdas, noise=noise, distr=distr,
        coupl_trafo=coupl_trafo, coupl_trafo2=coupl_trafo2, rng=data_rng,
        bk_style=bk_style)
    data, _ = normalize_data(spec, data)
    init = InitOptions(distr=tuple(distr), normalize=True,
                       lambdas_init=tuple(tuple(l) for l in lambdas))
    return data, init_coupled(spec, data, init, key=key,
                              delta_shapes=delta_shapes), init


def jax_mesh_fit(spec, data, state, options=OPTS, n=N):
    """The JAX package's fit(mesh=make_mesh(n)) with its own layouts."""
    mesh = make_mesh(n)
    data_sh, sharded = data_shardings(spec, data, mesh)
    return fit(spec, jax.device_put(data, data_sh),
               jax.device_put(state, state_shardings(spec, state, mesh,
                                                     sharded)),
               options, mesh=mesh)


def type4_flagship():
    """tests/test_mesh_coupled.py::test_mesh_type4_selector_flagship."""
    R1, R2, R3, RTOT = 3, 3, 2, 4
    spec = ProblemSpec(
        mode_sizes=(12, 16, 9, 12, 24, 5, 12, 32),
        datasets=(
            DatasetSpec(model="CP", modes=(0, 1, 2), rank=R1, weight=1 / 3),
            DatasetSpec(model="CP", modes=(3, 4, 5), rank=R2, weight=1 / 3),
            DatasetSpec(model="CP", modes=(6, 7), rank=R3, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN,) * 8)
    H2 = np.zeros((RTOT, R2))
    H2[[1, 2, 3], [0, 1, 2]] = 1.0
    trafo = [np.eye(RTOT, R1), None, None, H2, None, None,
             np.eye(RTOT, R3), None]
    data, state, _ = build(spec, [[1] * R1, [1] * R2, [1] * R3], ["rand"] * 8,
                           coupl_trafo=trafo, key=2)
    return spec, data, state


def type1():
    n1, n2 = 16, 8
    H_a = np.zeros((n2, n1))
    H_a[np.arange(n2), 2 * np.arange(n2)] = 1.0
    spec = ProblemSpec(
        mode_sizes=(n1, 24, 9, n2, 7),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(1,)),
        constraints=(None,) * 5)
    data, state, _ = build(spec, [[1, 1], [1, 1]],
                           ["rand", "randn", "randn", "rand", "randn"],
                           coupl_trafo=[H_a, None, None, np.eye(n2), None])
    return spec, data, state


def type2():
    rng = np.random.default_rng(5)
    H_a = rng.standard_normal((3, 3)) + 2 * np.eye(3)
    H_b = rng.standard_normal((3, 3)) + 2 * np.eye(3)
    spec = ProblemSpec(
        mode_sizes=(10, 16, 9, 10, 8),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=3, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(2,)),
        constraints=(None,) * 5)
    data, state, _ = build(spec, [[1] * 3] * 2, ["randn"] * 5,
                           coupl_trafo=[H_a, None, None, H_b, None])
    return spec, data, state


def type3():
    rng = np.random.default_rng(6)
    H_a = rng.standard_normal((12, 6))
    H_b = rng.standard_normal((12, 6))
    spec = ProblemSpec(
        mode_sizes=(12, 16, 9, 12, 8),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(3,)),
        constraints=(None,) * 5)
    data, state, _ = build(spec, [[1, 1], [1, 1]], ["randn"] * 5,
                           coupl_trafo=[H_a, None, None, H_b, None])
    return spec, data, state


def type5():
    R1, R2, n1, n2 = 3, 2, 10, 20
    H1_b = np.zeros((n1, n2))
    H1_b[np.arange(n1), 2 * np.arange(n1)] = 1.0
    H2_b = np.vstack([np.eye(R2), np.zeros((1, R2))])
    spec = ProblemSpec(
        mode_sizes=(n1, 16, 9, n2, 8, 6),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R1,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4, 5), rank=R2,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(5,)),
        constraints=(None,) * 6)
    data, state, _ = build(
        spec, [[1] * R1, [1] * R2], ["rand"] * 6,
        coupl_trafo=[np.eye(n1), None, None, H1_b, None, None],
        coupl_trafo2=[np.eye(R1), None, None, H2_b, None, None],
        delta_shapes={1: (n1, R1)})
    return spec, data, state


def sparse_coo(n=N):
    """tests/test_shard_mttkrp.py::test_fit_mesh_sparse_matches_plain's
    problem, its nnz padded to a multiple of n."""
    from matlab_code_tpu.parallel.shard_mttkrp import pad_sparse_nnz
    rng = np.random.default_rng(0)
    spec = ProblemSpec(
        mode_sizes=(12, 11, 10),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, None))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[1, 1]], noise=0.0, distr=["rand", "randn", "randn"],
        rng=7)
    data, _ = normalize_data(spec, data)
    Xd = np.array(data.objects[0])
    Xd[rng.uniform(size=Xd.shape) < 0.5] = 0.0
    data = dataclasses.replace(
        data, objects=(pad_sparse_nnz(SparseTensor.from_dense(Xd), n),))
    init = InitOptions(distr=("rand", "randn", "randn"), normalize=True,
                       lambdas_init=((1, 1),))
    return spec, data, init_coupled(spec, data, init, key=3)


def em_missing():
    """tests/test_mesh_coupled.py::test_mesh_em_missing_data."""
    spec = ProblemSpec(
        mode_sizes=(12, 16, 9, 12, 8),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                              weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4), rank=2, weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=(NN, None, None, NN, None))
    data, state, _ = build(spec, [[1, 1], [1, 1]],
                           ["rand", "randn", "randn", "rand", "randn"])
    rng = np.random.default_rng(3)
    miss = tuple(jax.numpy.asarray(
        rng.uniform(size=np.asarray(data.objects[p]).shape) > 0.2)
        for p in range(2))
    return spec, dataclasses.replace(data, miss=miss), state


def kl():
    """tests/test_mesh_coupled.py::test_mesh_kl_lbfgsb."""
    spec = ProblemSpec(
        mode_sizes=(10, 16, 9),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2,
                              loss="KL"),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, NN, NN))
    data, _, _, _ = create_coupled_data(
        spec, lambdas=[[25, 25]], noise=0.0, distr=["rand"] * 3, rng=6)
    init = InitOptions(distr=("rand",) * 3, normalize=False,
                       lambdas_init=((1, 1),))
    return spec, data, init_coupled(spec, data, init, key=5)


KL_OPTS = AlgOptions(MaxOuterIters=8, AbsFuncTol=0.0, OuterRelTol=0.0)


def par2_coupled():
    """tests/test_mesh_coupled.py::test_mesh_ragged_parafac2_coupled_A: a
    ragged PARAFAC2 dataset exactly coupled on mode A with a cut CP one."""
    sizes = (13, 17, 11, 19, 15, 13, 17, 11)
    K = len(sizes)
    spec = ProblemSpec(
        mode_sizes=(12, 16, 9, 12, sizes, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(NN, None, None, NN, None, NN))
    data, state, _ = build(
        spec, [[1, 1, 1], [1, 1, 1]],
        ["rand", "randn", "randn", "rand", "rand", "rand+0.1"], key=1)
    return spec, data, state


def check_fit(rank_results, name, jax_out=None, jax_state=None,
              traj_rtol=1e-11, jax_rtol=1e-10, fac_rtol=1e-8, fac_atol=1e-10):
    """Every rank's mesh fit against the port's plain fit (trajectory at
    traj_rtol, factors and couplings at fac_rtol / fac_atol) and against
    the JAX package's mesh fit (trajectory at jax_rtol, factors alike);
    every rank's final state bit-equal (replicas_agree) and equal to rank
    0's."""
    r0 = rank_results[0][name]
    plain = r0["plain"]
    for res in rank_results:
        got = res[name]["mesh"]
        assert got["agree"], "the ranks' states differ"
        assert got["iters"] == plain["iters"]
        np.testing.assert_allclose(got["f"], plain["f"], rtol=traj_rtol,
                                   atol=1e-13)
        for a, b in zip(got["fac"] + got["cpl"],
                        plain["fac"] + plain["cpl"]):
            if b is not None:
                np.testing.assert_allclose(a, b, rtol=fac_rtol,
                                           atol=fac_atol)
        for a, b in zip(got["fac"], r0["mesh"]["fac"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["inner"], plain["inner"])
    if jax_out is not None:
        got = r0["mesh"]
        np.testing.assert_allclose(got["f"], np.asarray(jax_out.func_val_conv),
                                   rtol=jax_rtol, atol=1e-13)
        for m, a in enumerate(got["fac"]):
            np.testing.assert_allclose(a, np.asarray(jax_state.fac[m]),
                                       rtol=fac_rtol, atol=fac_atol)
    return r0


# ------------------------------------------------- PARAFAC2 cut along K

RAGGED_SIZES = (13, 17, 11, 19, 15, 13, 17, 11)


def par2_regular(K=8):
    """A regular PARAFAC2 dataset, non-negative A and C, Bk free."""
    spec = ProblemSpec(
        mode_sizes=(12, (10,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, None, NN))
    data, state, _ = build(spec, [[1, 1, 1]], ["rand", "rand", "rand+0.1"])
    return spec, data, state


def par2_ragged():
    """tests/test_mesh_coupled.py::test_mesh_ragged_parafac2_bucketed_prox:
    ragged slices (three size buckets), every mode non-negative."""
    K = len(RAGGED_SIZES)
    spec = ProblemSpec(
        mode_sizes=(12, RAGGED_SIZES, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, NN, NN))
    data, state, _ = build(spec, [[1, 1, 1]], ["rand", "rand", "rand+0.1"])
    return spec, data, state


def par2_tpar2():
    """tests/test_parafac2.py's tPARAFAC2 problem (eta 10 on Bk), K = 8."""
    K = 8
    spec = ProblemSpec(
        mode_sizes=(9, (12,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=2),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("tPARAFAC2", (10.0,)), NN))
    data, state, _ = build(spec, [[1, 1]], ["randn", "rand", "rand+0.1"],
                           key=2, bk_style="smooth")
    return spec, data, state


def par2_c_type1():
    """tests/test_parafac2.py::test_par2_C_mode_coupled_type1 (script 14):
    the PARAFAC2 C mode (K = 6) coupled by type 1 with a CP mode, so the
    par2C update solves the (K R)^2 kron system."""
    K1, K2, J, I = 12, 6, 10, 8
    H_cp = np.zeros((K2, K1))
    H_cp[np.arange(K2), 2 * np.arange(K2)] = 1.0
    spec = ProblemSpec(
        mode_sizes=(K1, 9, 8, I, (J,) * K2, K2),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=2, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=2,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 0, 0, 1),
                              coupling_type=(1,)),
        constraints=(None,) * 6)
    data, state, _ = build(
        spec, [[1, 1], [1, 1]],
        ["rand", "randn", "randn", "rand", "rand", "rand+0.1"],
        coupl_trafo=[H_cp, None, None, None, None, np.eye(K2)], key=2)
    return spec, data, state


def par2_em():
    """par2_regular with 20 % of its entries missing (EM imputation on the
    rank's slices)."""
    spec, data, state = par2_regular()
    rng = np.random.default_rng(4)
    shape = np.asarray(data.objects[0].slices).shape
    miss = (jax.numpy.asarray(rng.uniform(size=shape) > 0.2),)
    return spec, dataclasses.replace(data, miss=miss), state
