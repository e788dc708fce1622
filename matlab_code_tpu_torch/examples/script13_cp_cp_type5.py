"""Example 13: CP rank 4 (50x30x40) + CP rank 3 (100x70x80), type-5 coupling
H1 C = Delta H2 with a double-sampling H1 and shared-subspace selectors H2
(first 3 of 4 components shared).  Port of
example_script13_CP_CP_doublesamplingrate_partialcoupling.m (coupling
:36-48, constraints :69-72).
Counterpart of examples/script13_cp_cp_type5.py on the port."""
import numpy as np

from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run

NN = ConstraintSpec("non-negativity")


def build(small=False):
    n1, n2 = 50, 100
    spec = ProblemSpec(
        mode_sizes=(n1, 30, 40, n2, 70, 80),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=4, weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(5,)),
        constraints=(NN, None, None, NN, NN, NN))
    H1_0 = np.eye(n1)
    H1_3 = np.zeros((n1, n2))
    for i in range(n1):
        H1_3[i, 2 * i] = 1.0
    H2_0 = np.eye(4)
    H2_3 = np.vstack([np.eye(3), np.zeros((1, 3))])
    opts = AlgOptions(MaxOuterIters=600 if small else 6000, MaxInnerIters=5,
                      AbsFuncTol=1e-8, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1] * 4, [1] * 3],
                distr=["rand", "randn", "randn", "rand", "rand", "rand"],
                coupl_trafo=[H1_0, None, None, H1_3, None, None],
                coupl_trafo2=[H2_0, None, None, H2_3, None, None],
                delta_shapes={1: (n1, 4)}, opts=opts, key=2)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """FULL reference-seeded replay of example_script13: data regenerated
    with the BIT-EXACT rng(4) draw sequence of
    create_coupled_data_example13.m — the type-5 coupled truth with the
    largest-mode override picking mode 4 (:138-139: sz 100 > 50, so
    A4 = rand(100,4) is drawn with lambdas{1}'s R=4, Delta = H4 @ A4,
    A1 = pinv(eye(50)) @ Delta at LAPACK-ulp, then A4 = A4 @ H2_4 selects
    the 3 shared components, :150), zero-noise draws consumed — then a
    SECOND stream rng(1) for init with the Delta size hint the reference
    passes as Deltatrue (example_script13:119-120).  Reference options
    AbsFuncTol 1e-8, inner tolerances 1e-3 (:128-133)."""
    import dataclasses
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    opts = dataclasses.replace(
        cfg["opts"],
        innerRelPrTol_coupl=1e-3, innerRelPrTol_constr=1e-3,
        innerRelDualTol_coupl=1e-3, innerRelDualTol_constr=1e-3)
    return run_reference_seeded(
        cfg["spec"], cfg["lambdas"], cfg["distr"], opts, noise=0.0,
        coupl_trafo=cfg["coupl_trafo"], coupl_trafo2=cfg["coupl_trafo2"],
        data_seed=4, init_seed=1, verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
