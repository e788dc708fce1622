"""The port's PARAFAC2 fits against the JAX package (continued from
test_torch_parafac2_fit.py): the par2C branches of coupling types 0-5 over
a fixed iteration count, the PARAFAC2 errors of check_data_input, and the
port's entry point on a PARAFAC2 problem from its own init.

Everything runs in float64 on the CPU.
"""
import numpy as np
import pytest
import torch

from matlab_code_tpu import ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec
from matlab_code_tpu.problem import check_data_input as jcheck

import matlab_code_tpu_torch as tp
from matlab_code_tpu_torch.convert import data_from_numpy, spec_from_reference
from matlab_code_tpu_torch.problem import check_data_input as tcheck
from test_torch_parafac2_fit import ITERS, NN, _fit_both, _opts, _par2_data


def _coupled_case(ctype, rng, K):
    """(mode sizes of the CP tensor's coupled mode and of the PAR2 C mode,
    H of each, H2 of each, delta_shapes) for the CP mode 2 / PAR2 C mode
    coupling of type ctype; R = 3."""
    R = 3
    if ctype == 0:
        return K, (None, None), (None, None), None
    if ctype == 1:   # double sampling rate, as script 14
        H = np.zeros((K // 2, K))
        H[np.arange(K // 2), 2 * np.arange(K // 2)] = 1.0
        return K // 2, (np.eye(K // 2), H), (None, None), None
    if ctype == 2:
        return K, tuple(rng.standard_normal((R, 2)) + 2 * np.eye(R, 2)
                        for _ in range(2)), (None, None), None
    if ctype == 3:
        return K, tuple(rng.standard_normal((K, 4)) for _ in range(2)), \
            (None, None), None
    if ctype == 4:
        return K, tuple(rng.standard_normal((2, R)) for _ in range(2)), \
            (None, None), None
    # the par2C rows solve Delta's rows (cmtf_fun_AOADMM.m:1026-1054), so
    # Delta has K rows: H maps onto K rows for both modes
    return K, (np.eye(K), rng.standard_normal((K, K)) + 3 * np.eye(K)), \
        (np.eye(R), np.eye(R)), {1: (K, R)}


@pytest.mark.parametrize("ctype", [0, 1, 2, 3, 4, 5])
def test_torch_par2C_coupled_fit_matches_jax(ctype):
    """A CP tensor's third mode coupled to a PARAFAC2 C mode by each
    coupling type (the par2C branches: per-row rho, the kron-vectorized
    system of types 1 and 5, the row-wise Delta systems of types 4 and 5),
    and type 0 also on the A mode (scripts 1 and 14), 8 outer iterations
    against the JAX fit."""
    K = 6
    rng = np.random.default_rng(20 + ctype)
    kc, H, H2, dshapes = _coupled_case(ctype, rng, K)
    lin = (2, 0, 1, 2, 0, 1) if ctype == 0 else (0, 0, 1, 0, 0, 1)
    types = (ctype, 0) if ctype == 0 else (ctype,)
    spec = ProblemSpec(
        mode_sizes=(7, 5, kc, 7, (6,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=lin, coupling_type=types),
        constraints=(NN, None, NN, NN, None, NN))
    objs = _par2_data((6,) * K, 7, 3, seed=ctype, cp_shape=(7, 5, kc))
    trafo = (None, None, H[0], None, None, H[1])
    trafo2 = (None, None, H2[0], None, None, H2[1]) if ctype == 5 else ()
    _, out = _fit_both(spec, objs, _opts(), trafo=trafo, trafo2=trafo2,
                       delta_shapes=dshapes)
    assert out.OuterIterations == ITERS


def test_torch_check_data_input_par2_errors():
    """The PARAFAC2 rules of check_data_input raise in the port where they
    raise in the JAX package: rank above a slice size, tPARAFAC2 off the Bk
    mode or on ragged slices, GL smoothness on ragged slices, a coupled Bk
    mode, a C mode whose size is not K."""
    def spec(sizes=(5, 5, 5), cons=(None, None, None), lin=(0, 0, 0),
             types=(), R=3, c=3):
        return ProblemSpec(
            mode_sizes=(4, sizes, c),
            datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
            coupling=CouplingSpec(lin, types), constraints=cons)

    T = ConstraintSpec("tPARAFAC2", (1.0,))
    bad = [spec(R=6), spec(cons=(T, None, None)),
           spec(sizes=(5, 4, 5), cons=(None, T, None)),
           spec(sizes=(5, 4, 5), cons=(None, ConstraintSpec(
               "GL smoothness", (1.0,)), None)),
           spec(lin=(0, 1, 0), types=(0,)), spec(c=4)]
    for s in bad:
        with pytest.raises(ValueError) as jerr:
            jcheck(s)
        with pytest.raises(ValueError) as terr:
            tcheck(spec_from_reference(s))
        assert str(terr.value)[:40] == str(jerr.value)[:40]
    jcheck(spec())
    tcheck(spec_from_reference(spec()))


def test_torch_par2_cmtf_aoadmm_from_its_own_init():
    """The port's entry point on a PARAFAC2 problem on the CPU, from its own
    init (torch.Generator draws; P_k = I on each slice's J_k rows, the
    padding zero), with a Zhat of {A, Bk (true sizes), C}; nvecs init too."""
    sizes = (7, 9, 8, 9)
    spec = tp.ProblemSpec(
        mode_sizes=(6, sizes, 4),
        datasets=(tp.DatasetSpec("PAR2", (0, 1, 2), 2),),
        constraints=(tp.ConstraintSpec("non-negativity"), None,
                     tp.ConstraintSpec("non-negativity")))
    objs = _par2_data(sizes, 6, 2, seed=9)
    data = data_from_numpy(objs, device="cpu")
    for nvecs in (False, True):
        init = tp.InitOptions(distr=("rand",) * 3, nvecs=nvecs)
        state0 = tp.init_coupled(spec, data, init, seed=1)
        assert state0.fac[1].shape == state0.P[0].shape == (4, 9, 2)
        assert state0.DeltaB[0].shape == (2, 2)
        for k, J in enumerate(sizes):
            assert torch.equal(state0.P[0][k, :J],
                               torch.eye(J, 2, dtype=torch.float64))
            assert not bool(state0.fac[1][k, J:].any())
            assert not bool(state0.mu_DeltaB[0][k, J:].any())
        zhat, _, _, out = tp.cmtf_aoadmm(
            spec, data, tp.AlgOptions(MaxOuterIters=30), init=state0)
        assert out.func_val_conv[-1] < 0.2 * out.func_val_conv[0]
        assert [b.shape for b in zhat[0]["Bk"]] == [(J, 2) for J in sizes]
        assert zhat[0]["A"].shape == (6, 2) and zhat[0]["C"].shape == (4, 2)
