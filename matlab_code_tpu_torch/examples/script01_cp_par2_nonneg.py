"""Example 1: CP (20x30x40) + PARAFAC2 (20 x 30*20 x 20), exactly coupled in
the first mode, nonnegativity on PAR2 modes + CP mode 1.
Port of example_script1_CP_PAR2_nonneg.m (sizes :21, coupling :32-33,
constraints :51-58, options :110-123).
Counterpart of examples/script01_cp_par2_nonneg.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run

NN = ConstraintSpec("non-negativity")


def build(small=False):
    K, J = (8, 15) if small else (20, 30)
    spec = ProblemSpec(
        mode_sizes=(20, 30, 40, 20, (J,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(NN, None, None, NN, NN, NN))
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1], [1, 1, 1]],
                distr=["rand", "randn", "randn", "rand", "rand", "rand+0.1"],
                opts=opts, key=2)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """FULL reference-seeded replay of example_script1: regenerates the
    synthetic data with the BIT-EXACT rng("default") draw sequence of
    create_coupled_data.m (rand/randn/shift-PARAFAC + the zero-level noise
    tensors MATLAB still draws), normalizes per example_script1:86-103,
    then continues the SAME stream through init_coupled_AOADMM_CMTF.m's
    draw order (example_script1:13,85,107) — every random draw matches the
    reference bit-for-bit; the assembled data arrays match to float64
    rounding (the ktensor/noise products' association order is the one
    place MATLAB's BLAS could differ in the last ulp).  Returns the run
    dict plus the
    randn slow-path counts (0 = every normal draw took the anchor-verified
    fast path; see utils/matlab_rng.py)."""
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    return run_reference_seeded(cfg["spec"], cfg["lambdas"], cfg["distr"],
                                cfg["opts"], noise=0.0, verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
