"""Example 15: EEM/NMR/LCMS-style triple fusion — three CP datasets (two
3-way tensors + one matrix) sharing the sample mode through a type-4
selector coupling (EEM uses 3 of 6 latent components, NMR 5, LCMS a
permuted/partial 5), all modes nonneg, best of N random starts by minimum
f_tensors.  The reference's raw EEM_NMR_LCMS.mat is not redistributable
(example_script15:11, .MISSING_LARGE_BLOBS); this port reproduces the full
pipeline — selector matrices :47-51, 20 random starts :113-135, options
:101-108 — on synthetic data whose shared sample mode is seeded from the
experiment's real 29x5 chemical design where the shipped TrueDesign.mat
(example_script15:138, data_for_example15/ of the checkout that
CMTF_REFERENCE_DIR names) is mounted, with a random design fallback.

Counterpart of examples/script15_realdata.py on the port."""
import numpy as np

from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import reference_path

NN = ConstraintSpec("non-negativity")
TRUEDESIGN = ("data_for_example15", "TrueDesign.mat")


def _truedesign_delta():
    """The REAL 29x5 chemical design (data_for_example15/TrueDesign.mat,
    loaded by the reference's evaluation at example_script15_realdata.m:138)
    as the shared sample-mode ground truth, padded with one random extra
    component to the 6-column Delta the selector matrices expect."""
    path = reference_path(*TRUEDESIGN)
    if path is None:
        return None
    import scipy.io as sio
    D5 = np.asarray(sio.loadmat(path)["A"], float)              # (29, 5)
    D5 = D5 / np.linalg.norm(D5, axis=0, keepdims=True)
    rng = np.random.default_rng(15)
    extra = rng.uniform(0.1, 1.0, size=(D5.shape[0], 1))
    extra /= np.linalg.norm(extra)
    return np.hstack([D5, extra])                               # (29, 6)


def build(small=False):
    design = _truedesign_delta()
    S = 28 if design is None else design.shape[0]  # samples
    spec = ProblemSpec(
        mode_sizes=(S, 60, 30, S, 80, 16, S, 120),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3,
                              weight=1 / 3),
                  DatasetSpec(model="CP", modes=(3, 4, 5), rank=5,
                              weight=1 / 3),
                  DatasetSpec(model="CP", modes=(6, 7), rank=5,
                              weight=1 / 3)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0, 1, 0),
                              coupling_type=(4,)),
        constraints=(NN,) * 8)
    # selector matrices (example_script15:47-51): Delta has 6 columns
    H0 = np.vstack([np.eye(3), np.zeros((3, 3))])            # (6, 3)
    H3 = np.vstack([np.eye(5), np.zeros((1, 5))])            # (6, 5)
    T = np.hstack([np.eye(4), np.zeros((4, 1))])
    T = np.vstack([T, np.zeros((1, 5)), np.array([[0, 0, 0, 0, 1]])])  # (6,5)
    H6 = T
    opts = AlgOptions(MaxOuterIters=1000 if small else 20000, MaxInnerIters=5,
                      AbsFuncTol=1e-4, OuterRelTol=1e-10)
    return dict(spec=spec, lambdas=[[1] * 3, [1] * 5, [1] * 5],
                distr=["rand"] * 8,
                coupl_trafo=[H0, None, None, H3, None, None, H6, None],
                opts=opts, noise=0.03,
                delta_override=None if design is None else {1: design})


def main(n_starts=20, small=False, device=None, dtype=None, max_iters=None,
         verbose=True):
    """Best of n_starts random inits by minimum f_tensors
    (example_script15:113-135), all starts on one start axis
    (fit_multistart; start s is the fit of run(..., key=s)).  max_iters
    caps MaxOuterIters."""
    import dataclasses
    from matlab_code_tpu_torch.examples.common import run_multistart
    cfg = build(small=small)
    if max_iters is not None:
        cfg["opts"] = dataclasses.replace(cfg["opts"], MaxOuterIters=max_iters)
    return run_multistart(**cfg, n_starts=n_starts, device=device,
                          dtype=dtype, verbose=verbose)


if __name__ == "__main__":
    main()
