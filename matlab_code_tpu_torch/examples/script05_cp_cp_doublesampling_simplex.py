"""Example 5: CP (50x30x40) + CP (100x70x80) rank 4, type-1 coupling
H C = Delta with a double-sampling-rate selector (every 2nd row of the
100-row factor), column-wise simplex constraint on mode 5.
Port of example_script5_CP_CP_doublesamplingrate_simplex.m
(sizes :26, coupling :37-44, constraint :67).
Counterpart of examples/script05_cp_cp_doublesampling_simplex.py on the port."""
import numpy as np

from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run


def build(small=False):
    n1, n2 = 50, 100
    spec = ProblemSpec(
        mode_sizes=(n1, 30, 40, n2, 70, 80),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=4, weight=0.5),
                  DatasetSpec(model="CP", modes=(3, 4, 5), rank=4,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(1,)),
        constraints=(None, None, None, None, None,
                     ConstraintSpec("simplex column-wise", (1.0,))))
    H0 = np.eye(n1)
    H3 = np.zeros((n1, n2))
    for i in range(n1):
        H3[i, 2 * i] = 1.0
    # mode 5's true factor lives on the simplex (example5simplex:73-77)
    simplex_post = {5: lambda A: A / A.sum(axis=0, keepdims=True)}
    opts = AlgOptions(MaxOuterIters=600 if small else 6000, MaxInnerIters=5,
                      AbsFuncTol=1e-4, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1] * 4, [1] * 4],
                distr=["rand", "randn", "randn", "rand", "rand", "rand"],
                coupl_trafo=[H0, None, None, H3, None, None],
                mode_post=simplex_post, opts=opts, key=2)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """FULL reference-seeded replay of example_script5: data regenerated
    with the BIT-EXACT rng("default") draw sequence of
    create_coupled_data_example5simplex.m — the reference's all-randn
    distr (mode 6 rand, :31), the in-loop simplex normalization of mode 6
    (:73-77, draw-free so applied via post_uncoupled), and the type-1
    coupled truth WITHOUT the main factory's largest-mode override
    (:100-110: mode1 = cp_modes(1)), A4 = pinv(H4) @ Delta at LAPACK-ulp
    — then init on the same stream.  Reference options AbsFuncTol 1e-4,
    inner tolerances 1e-3 (example_script5:123-128)."""
    import dataclasses
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    distr = ["randn", "randn", "randn", "randn", "randn", "rand"]

    def simplex_mode6(A, rng):
        A[5] = A[5] / A[5].sum(axis=0, keepdims=True)

    opts = dataclasses.replace(
        cfg["opts"],
        innerRelPrTol_coupl=1e-3, innerRelPrTol_constr=1e-3,
        innerRelDualTol_coupl=1e-3, innerRelDualTol_constr=1e-3)
    return run_reference_seeded(
        cfg["spec"], cfg["lambdas"], distr, opts, noise=0.2,
        coupl_trafo=cfg["coupl_trafo"], case1_max_override=False,
        post_uncoupled=simplex_mode6, verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
