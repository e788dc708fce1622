"""Coupling types 1, 2, 3 and 5 in the port against the JAX package, on
the CPU in float64: the Sylvester solve and the init shapes of every type
(the CP surface workload's fits: test_torch_couplings_surface.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from matlab_code_tpu import (
    ConstraintSpec, CouplingSpec, DatasetSpec, InitOptions, ProblemData,
    ProblemSpec)
from matlab_code_tpu.models.init import init_coupled as jinit_coupled
from matlab_code_tpu.ops.linalg import sylvester_sym as jsylvester

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import data_from_numpy, state_to_numpy
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.ops.linalg import sylvester_sym

SCALE = 8   # the surface workload's mode sizes / 8


def test_torch_sylvester_sym_matches_jax():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((9, 9))
    B2 = M @ M.T + np.eye(9)
    G = rng.standard_normal((4, 4))
    B = G @ G.T
    C = rng.standard_normal((9, 4))
    got = sylvester_sym(torch.tensor(B2), torch.tensor(B), torch.tensor(C))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsylvester(
        jnp.asarray(B2), jnp.asarray(B), jnp.asarray(C))), rtol=1e-12,
        atol=1e-14)
    np.testing.assert_allclose((torch.tensor(B2) @ got + got @ torch.tensor(B)
                                ).numpy(), C, atol=1e-12)


def _pair(ctype):
    """A 3-way CP + CP pair coupled on modes 0/3 at type ctype, with the H
    (and H2) matrices the type takes."""
    n0, n3 = (20, 10) if ctype in (1, 5) else (10, 10)
    R = (3, 2) if ctype in (4, 5) else (2, 2)
    spec = ProblemSpec(
        mode_sizes=(n0, 6, 7, n3, 8),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R[0]),
                  DatasetSpec(model="CP", modes=(3, 4), rank=R[1])),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(ctype,)),
        constraints=(ConstraintSpec("non-negativity"),) + (None,) * 4)
    rng = np.random.default_rng(ctype)
    H = H2 = (None,) * 5
    if ctype in (1, 5):
        sel = np.zeros((10, 20))
        sel[np.arange(10), 2 * np.arange(10)] = 1.0
        H = (sel, None, None, np.eye(10), None)
    elif ctype == 2:
        H = (rng.standard_normal((2, 2)), None, None,
             rng.standard_normal((2, 2)), None)
    elif ctype == 3:
        H = (rng.standard_normal((10, 4)), None, None,
             rng.standard_normal((10, 4)), None)
    elif ctype == 4:
        H = (np.eye(3), None, None, np.vstack([np.eye(2), np.zeros((1, 2))]),
             None)
    if ctype == 5:
        H2 = (np.eye(3), None, None, np.vstack([np.eye(2), np.zeros((1, 2))]),
              None)
    objects = (rng.uniform(size=(n0, 6, 7)), rng.uniform(size=(n3, 8)))
    return spec, objects, H, H2


@pytest.mark.parametrize("ctype", [0, 1, 2, 3, 4, 5])
def test_torch_init_shapes_match_jax(ctype):
    """Every field of the port's init state has the JAX package's shape
    for each coupling type; type 5 takes its Delta shape from
    delta_shapes and raises ValueError without it, in both packages."""
    spec, objects, H, H2 = _pair(ctype)
    init = InitOptions(distr=("rand",) * 5, normalize=True)
    ds = {1: (10, 3)} if ctype == 5 else None
    jdata = ProblemData(objects=tuple(map(jnp.asarray, objects)),
                        coupl_trafo=tuple(None if h is None else jnp.asarray(h)
                                          for h in H),
                        coupl_trafo2=tuple(None if h is None else jnp.asarray(h)
                                           for h in H2))
    want = jinit_coupled(spec, jdata, init, key=1, delta_shapes=ds)
    tspec = tp.ProblemSpec(
        mode_sizes=spec.mode_sizes,
        datasets=tuple(tp.DatasetSpec(d.model, d.modes, d.rank)
                       for d in spec.datasets),
        coupling=tp.CouplingSpec(spec.coupling.lin_coupled_modes,
                                 spec.coupling.coupling_type),
        constraints=(tp.ConstraintSpec("non-negativity"),) + (None,) * 4)
    tdata = data_from_numpy(objects, H, H2, device="cpu")
    tp.check_data_input(tspec, tdata)
    got = state_to_numpy(init_coupled(tspec, tdata, tp.InitOptions(
        distr=("rand",) * 5, normalize=True), seed=1, delta_shapes=ds))
    for field in ("fac", "constraint_fac", "constraint_dual_fac",
                  "coupling_fac", "coupling_dual_fac"):
        assert [None if a is None else a.shape for a in got[field]] == [
            None if a is None else tuple(a.shape)
            for a in getattr(want, field)], field
    if ctype == 5:
        with pytest.raises(ValueError, match="delta_shapes"):
            init_coupled(tspec, tdata, tp.InitOptions(distr=("rand",) * 5),
                         seed=1)
        with pytest.raises(ValueError, match="delta_shapes"):
            jinit_coupled(spec, jdata, init, key=1)
        with pytest.raises(ValueError, match="delta_shapes"):
            tp.cmtf_aoadmm(tspec, tdata, tp.AlgOptions(MaxOuterIters=1),
                           init_options=tp.InitOptions(distr=("rand",) * 5))
