"""Example 8: regular PARAFAC2 (40 x 120*60 x 60), all modes nonneg.
Port of example_script8_regularPAR2_nonneg.m (sizes :19, constraints :51-53).
Counterpart of examples/script08_regular_par2_nonneg.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run

NN = ConstraintSpec("non-negativity")


def build(small=False):
    K, J = (12, 24) if small else (60, 120)
    spec = ProblemSpec(
        mode_sizes=(40, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(NN, NN, NN))
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1]],
                distr=["rand", "rand", "rand+0.1"], opts=opts, key=2)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """Reference-seeded replay of example_script8 (rng("default") data +
    init, noise 0.2 per :23; see examples/common.run_reference_seeded)."""
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    return run_reference_seeded(cfg["spec"], cfg["lambdas"], cfg["distr"],
                                cfg["opts"], noise=0.2, verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
