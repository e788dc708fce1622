"""Example 2: matrix (40x60) + PARAFAC2 (40 x 120*50 x 50), exact coupling of
the matrix's first mode with the PAR2 A mode, everything nonneg.
Port of example_script2_matrix_PAR2_nonneg.m (sizes :20, coupling :31,
constraints :55-59).
Counterpart of examples/script02_matrix_par2_nonneg.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run

NN = ConstraintSpec("non-negativity")


def build(small=False):
    K, J = (10, 24) if small else (50, 120)
    spec = ProblemSpec(
        mode_sizes=(40, 60, 40, (J,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1), rank=3, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(2, 3, 4), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(NN, NN, NN, NN, NN))
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1], [1, 1, 1]],
                distr=["rand", "rand", "rand", "rand", "rand+0.1"],
                opts=opts, key=2)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """Reference-seeded replay of example_script2 (rng("default") data +
    init, noise 0.5 per :24; see examples/common.run_reference_seeded)."""
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    return run_reference_seeded(cfg["spec"], cfg["lambdas"], cfg["distr"],
                                cfg["opts"], noise=0.5, verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
