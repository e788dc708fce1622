"""The port's fit against the JAX package's with a KL dataset coupled to
another dataset under each of the coupling types 1-5 (the L-BFGS-B value
and gradient with each type's quadratic term, models/lbfgs_bridge.py, and
the consensus update beside it), in float64 on the CPU, at tiny sizes: the
four streams at rtol 1e-8 and the inner and L-BFGS-B iteration counts
equal over a fixed iteration count (test_torch_nonfrob_fit.compare_fits).
Type 0 is script 07's, in tests/test_torch_nonfrob_fit.py.  The factors
are drawn from U(0.1, 1.1) and the coupling matrices are non-negative, so
the data are positive and the problems away from the bound at 0 (see
test_torch_nonfrob_fit.py on why)."""
import numpy as np
import pytest

from matlab_code_tpu import (
    AlgOptions, ConstraintSpec, CouplingSpec, DatasetSpec, ProblemSpec)
from matlab_code_tpu.options import LbfgsbOptions

from test_torch_nonfrob_fit import compare_fits, problem

NN = ConstraintSpec("non-negativity")


def _pair(ctype, n0, n3, losses, R=(2, 2), constraints=(None,) * 5):
    """A 3-way dataset (modes 0-2) and a matrix (modes 3-4), modes 0 and 3
    coupled by ctype."""
    return ProblemSpec(
        mode_sizes=(n0, 6, 7, n3, 8),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=R[0],
                              weight=0.5, loss=losses[0]),
                  DatasetSpec(model="CP", modes=(3, 4), rank=R[1], weight=0.5,
                              loss=losses[1])),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(ctype,)),
        constraints=constraints)


def _config(ctype):
    rng = np.random.default_rng(10 + ctype)
    trafo2 = delta_shapes = None
    if ctype == 1:
        # a half-rate sampling of mode 0: H_a C_0 = Delta = C_3
        spec = _pair(1, 12, 6, ("KL", "KL"))
        H = np.zeros((6, 12))
        H[np.arange(6), 2 * np.arange(6)] = 1.0
        trafo = [H, None, None, np.eye(6), None]
    elif ctype == 2:
        # C_p H_p = Delta, a KL tensor beside a Frobenius matrix
        spec = _pair(2, 8, 8, ("KL", "Frobenius"))
        trafo = [rng.uniform(size=(2, 2)) + 2 * np.eye(2), None, None,
                 rng.uniform(size=(2, 2)) + 2 * np.eye(2), None]
    elif ctype == 3:
        spec = _pair(3, 9, 9, ("KL", "KL"))
        trafo = [rng.uniform(size=(9, 4)), None, None,
                 rng.uniform(size=(9, 4)), None]
    elif ctype == 4:
        # the selector H = [I; 0]; mode 0 also non-negative, so its
        # L-BFGS-B steps carry both quadratic terms
        spec = _pair(4, 8, 8, ("KL", "Frobenius"), R=(3, 2),
                     constraints=(NN, None, None, NN, None))
        trafo = [np.eye(3), None, None,
                 np.vstack([np.eye(2), np.zeros((1, 2))]), None]
    else:
        # H_p C_p = Delta H2_p, ranks 3 and 2 (script 13's shape)
        spec = _pair(5, 6, 12, ("KL", "KL"), R=(3, 2))
        H = np.zeros((6, 12))
        H[np.arange(6), 2 * np.arange(6)] = 1.0
        trafo = [np.eye(6), None, None, H, None]
        trafo2 = [np.eye(3), None, None,
                  np.vstack([np.eye(2), np.zeros((1, 2))]), None]
        delta_shapes = {1: (6, 3)}
    return problem(spec, ["rand+0.1"] * 5, key=3, trafo=trafo, trafo2=trafo2,
                   delta_shapes=delta_shapes)


@pytest.mark.parametrize("ctype", [1, 2, 3, 4, 5])
def test_torch_fit_matches_jax_kl_coupled(ctype):
    spec, data, state0 = _config(ctype)
    opts = AlgOptions(MaxOuterIters=4, AbsFuncTol=0.0, OuterRelTol=0.0,
                      lbfgsb=LbfgsbOptions(m=5, maxIts=100, pgtol=1e-7))
    out = compare_fits(spec, data, state0, opts)
    kl_modes = [m for p, ds in enumerate(spec.datasets) if ds.loss == "KL"
                for m in ds.modes]
    assert out.lbfgsb_iterations[kl_modes, 1:].min() >= 1
