"""Example 4: irregular PARAFAC2 (40 x [61..120] x 60), orthonormal true Bk,
nonneg C.  Port of example_script4_irregularPAR2.m (sizes :18,
constraints :51).
Counterpart of examples/script04_irregular_par2.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run


def build(small=False):
    sizes = tuple(range(21, 33)) if small else tuple(range(61, 121))
    spec = ProblemSpec(
        mode_sizes=(40, sizes, len(sizes)),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, None, ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1]],
                distr=["randn", "randn", "rand+0.1"], opts=opts, key=2,
                bk_style="orth")


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """FULL reference-seeded replay of example_script4: data regenerated
    with the BIT-EXACT rng("default") draw sequence of
    create_irregularPARAFAC2_coupled_data.m — the consumed-and-discarded
    61x3 randn block (:58), then per-slice orth(randn(J_k,3)) for
    J_k = 61..120 (:63-70, orth's SVD reproduces MATLAB's LAPACK result to
    ulp), noise draws at level 0.2 — then init on the same stream (ragged
    per-slice draws, init:77-87).  Reference options
    example_script4:105-112."""
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    return run_reference_seeded(
        cfg["spec"], cfg["lambdas"], cfg["distr"], cfg["opts"], noise=0.2,
        bk_style="orth", verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
