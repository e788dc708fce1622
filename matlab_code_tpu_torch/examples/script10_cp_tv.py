"""Example 10: CP (60x50x70) with TV regularization (eta=0.001) on mode 0
(piecewise-constant truth) and l2-ball on modes 1-2.
Port of example_script10_CP_TVreg.m (sizes :23, constraints :55-57,
piecewise truth create_CP_data_example10piecewiseconstant.m:78-89).
Counterpart of examples/script10_cp_tv.py on the port."""
import numpy as np

from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run


def piecewise_constant(rng, shape):
    """5-level piecewise-constant columns (example10 generator :78-89)."""
    n, R = shape
    A = np.zeros((n, R))
    for r in range(R):
        jumps = np.concatenate([[0], np.sort(rng.integers(1, n, 4)), [n]])
        vals = -1 + 2 * rng.uniform(size=5)
        for i in range(5):
            A[jumps[i]:jumps[i + 1], r] = vals[i]
    return A


def build(small=False):
    spec = ProblemSpec(
        mode_sizes=(60, 50, 70),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(ConstraintSpec("TV regularization", (0.001,)),
                     ConstraintSpec("l2-ball", (1.0,)),
                     ConstraintSpec("l2-ball", (1.0,))))
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1]],
                distr=[piecewise_constant, "randn", "randn"],
                init_distr=["randn", "randn", "randn"], opts=opts,
                key=2, noise=0.05)


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """Reference-seeded replay of example_script10: rng("default") data +
    init with the piecewise-constant overwrite of
    create_CP_data_example10piecewiseconstant.m:78-89 replayed draw-for-
    draw (randi jump points + uniform levels between the uncoupled and
    coupled phases), noise 0.8 (:27), normalize_columns=1 (:29).  The
    l2-ball/TV prox applications in the aux init pass through the port's
    proxes (kernel B on the card), so those aux variables match MATLAB's to float64
    rounding rather than bitwise; the factor draws themselves are
    bit-exact."""
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()

    def piecewise_matlab(A, rng):
        # jumps = [1; sort(randi(60,4,1)); 60]; values = -1+2*rand(5,1)
        n, R = A[0].shape
        for r in range(R):
            jumps = np.concatenate(
                [[1], np.sort(rng.randi(n, 4)), [n]]).astype(int)
            vals = -1.0 + 2.0 * rng.rand(5)
            for i in range(5):
                A[0][jumps[i] - 1:jumps[i + 1], r] = vals[i]
        A[0] /= np.linalg.norm(A[0], axis=0, keepdims=True)  # :86-89

    return run_reference_seeded(
        cfg["spec"], cfg["lambdas"], ["randn", "randn", "randn"],
        cfg["opts"], noise=0.8, verbose=verbose, normalize_columns=True,
        post_uncoupled=piecewise_matlab, device=device, dtype=dtype,
        overrides=overrides)


if __name__ == "__main__":
    run(**build())
