"""Example 14: CP (20x30x40) + PARAFAC2 (20 x 30*40 x 40) coupled through the
PAR2 C mode with a type-1 double-sampling-rate coupling (CP mode 0 vs every
2nd PAR2 slice weight), all nonneg except Bk.
Port of example_script14_CP_PAR2_couplC_doublesamplingrate.m (sizes :20,
coupling :31-38, constraints :61-65).
Counterpart of examples/script14_cp_par2_couplC.py on the port."""
import numpy as np

from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run

NN = ConstraintSpec("non-negativity")


def build(small=False):
    K1, K2 = 20, 40
    if small:
        K1, K2 = 10, 20
    J = 30
    spec = ProblemSpec(
        mode_sizes=(K1, 30, 40, K1, (J,) * K2, K2),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 0, 0, 1),
                              coupling_type=(1,)),
        constraints=(NN, NN, NN, NN, None, NN))
    H0 = np.eye(K1)
    H5 = np.zeros((K1, K2))
    for i in range(K1):
        H5[i, 2 * i] = 1.0
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1], [1, 1, 1]],
                distr=["rand", "rand", "rand", "rand", "rand", "rand+0.1"],
                coupl_trafo=[H0, None, None, None, None, H5],
                opts=opts, key=2)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """FULL reference-seeded replay of example_script14: data regenerated
    with the BIT-EXACT rng("default") draw sequence of
    create_coupled_data.m — shift-PARAFAC Bk from randn (:64-72), the
    type-1 coupling on the PAR2 C-mode with the largest-mode override
    picking mode 6 (:96-97: sz 40 > 20, so A6 = rand(40,3)+0.1 is drawn,
    Delta = H6 @ A6, A1 = pinv(eye(20)) @ Delta at LAPACK-ulp), zero-level
    noise draws still consumed — then init on the same stream.  Reference
    options MaxOuterIters=10000 (example_script14:116-123)."""
    import dataclasses
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    opts = dataclasses.replace(cfg["opts"], MaxOuterIters=10000)
    return run_reference_seeded(
        cfg["spec"], cfg["lambdas"], cfg["distr"], opts, noise=0.0,
        coupl_trafo=cfg["coupl_trafo"], verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
