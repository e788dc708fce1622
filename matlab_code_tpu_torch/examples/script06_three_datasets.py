"""Example 6: 3-way CP (50x60x40) + matrix (50x70) + matrix (60x80), two
exact couplings (tensor mode 0 with matrix-1 row mode; tensor mode 1 with
matrix-2 row mode), nonneg everywhere except tensor mode 2.
Port of example_script6_matrix_matrix_CP_nonneg.m (sizes :25, coupling :37,
constraints :63-68).
Counterpart of examples/script06_three_datasets.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run

NN = ConstraintSpec("non-negativity")


def build(small=False):
    spec = ProblemSpec(
        mode_sizes=(50, 60, 40, 50, 70, 60, 80),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=1 / 3),
                  DatasetSpec(model="CP", modes=(3, 4), rank=3, weight=1 / 3),
                  DatasetSpec(model="CP", modes=(5, 6), rank=3, weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 2, 0, 1, 0, 2, 0),
                              coupling_type=(0, 0)),
        # constrained_modes = [1 0 0 1 1 1 1] (example_script6:59) GATES the
        # constraints cell: the nonneg spec at constraints{2} (:64) is
        # inactive in the reference, so mode 1 here is unconstrained
        constraints=(NN, None, None, NN, NN, NN, NN))
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1]] * 3, distr=["rand"] * 7,
                opts=opts, key=2)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """Reference-seeded replay of example_script6 (rng("default") data +
    init, noise 0.2 per :29, the reference's exact distr with randn on
    mode 3 per :30; see examples/common.run_reference_seeded).  The
    reference's own tolerances are looser than build()'s
    (options.AbsFuncTol = 1e-4, inner tolerances 1e-3,
    example_script6:124-129), so override them here to run the exact
    reference configuration."""
    import dataclasses
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    distr = ["rand", "rand", "randn", "rand", "rand", "rand", "rand"]
    opts = dataclasses.replace(
        cfg["opts"], AbsFuncTol=1e-4,
        innerRelPrTol_coupl=1e-3, innerRelPrTol_constr=1e-3,
        innerRelDualTol_coupl=1e-3, innerRelDualTol_constr=1e-3)
    return run_reference_seeded(cfg["spec"], cfg["lambdas"], distr,
                                opts, noise=0.2, verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
