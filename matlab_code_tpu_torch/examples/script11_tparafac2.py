"""Example 11: tPARAFAC2 -- PARAFAC2 with temporal smoothness (eta=1000) on
the Bk mode, nonneg C and ridge [100,0,100] on A/C.

Where the reference's shipped fixtures are mounted (noisy_dataset.mat +
gnd_factors.mat under functions_for_example_scripts/ of the checkout that
CMTF_REFERENCE_DIR names, loaded at example_script11_tPARAFAC2.m:20-42),
`run_real()` replays the reference configuration (constraints :73-77,
options :125-135, AbsFuncTol 1e-14) on that data and scores Fit +
FMS_A/B/C against the shipped ground truth.  `build()` is a synthetic
stand-in with matched statistics for a machine without the fixtures.
On the card the Bk prox is kernel C (csrc/t_smooth.cu).

Counterpart of examples/script11_tparafac2.py on the port."""
import os

from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import reference_path, run

FIXTURES = "functions_for_example_scripts"


def run_real(fixture_dir=None, key=11, verbose=True, reference_init=False,
             save_plots=None, device=None, dtype=None, **overrides):
    """Replay example_script11 on the shipped .mat fixtures (fixture_dir, or
    the reference checkout's); returns a dict with fit (percent,
    example_script11:146-153), fms_A/B/C (:157-165) and the solver output.

    reference_init=True draws the init on the MATLAB twister stream after
    rng("default") (utils/matlab_rng.matlab_init_coupled): script 11 loads
    its data from .mat, so the init is its whole post-seed random stream.
    overrides: AlgOptions fields replaced in the reference's options."""
    import dataclasses

    import numpy as np
    import scipy.io as sio
    import torch

    from matlab_code_tpu_torch import InitOptions, Parafac2Tensor, ProblemData
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import fit
    from matlab_code_tpu_torch.utils.datagen import resolve_device
    from matlab_code_tpu_torch.utils.score import fms, fms_par2_B

    fixture_dir = fixture_dir or reference_path(FIXTURES)
    if fixture_dir is None:
        raise FileNotFoundError(
            "script 11's fixtures are not mounted: set CMTF_REFERENCE_DIR to "
            "the reference's checkout or pass fixture_dir")
    device, dtype = resolve_device(device, dtype)
    g = sio.loadmat(os.path.join(fixture_dir, "gnd_factors.mat"))
    A_t, B_t, C_t = g["A"], g["B"], g["C"]       # (100,3),(25,80,3),(25,3)
    ds = sio.loadmat(os.path.join(fixture_dir, "noisy_dataset.mat"))
    X = ds["dataset"]                            # (100, 80, 25)
    K, R = C_t.shape[0], 3
    slices = [X[:, :, k] for k in range(K)]
    spec = ProblemSpec(
        mode_sizes=(A_t.shape[0], (B_t.shape[1],) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=R),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("tPARAFAC2", (1000.0,)),
                     ConstraintSpec("non-negativity")),
        ridge=(100.0, 0.0, 100.0))               # example_script11:77
    # the reference does not normalize this dataset (the division loop at
    # example_script11:115-117 is commented out)
    data = ProblemData(
        objects=(Parafac2Tensor.from_list(
            [torch.tensor(np.asarray(s, float)) for s in slices],
            dtype=dtype, device=device),),
        coupl_trafo=(None,) * 3, coupl_trafo2=(None,) * 3)
    if reference_init:
        from matlab_code_tpu_torch.utils.matlab_rng import matlab_init_coupled
        state0 = matlab_init_coupled(spec, distr=("rand",) * 3,
                                     normalize=False, device=device,
                                     dtype=dtype)  # :64-68, rng default
    else:
        init = InitOptions(distr=("rand",) * 3, normalize=False,
                           lambdas_init=((1,) * R,))  # example_script11:64-68
        state0 = init_coupled(spec, data, init, seed=key)
    opts = AlgOptions(MaxOuterIters=6000, MaxInnerIters=5, AbsFuncTol=1e-14,
                      OuterRelTol=1e-8, innerRelPrTol_coupl=1e-4,
                      innerRelPrTol_constr=1e-4, innerRelDualTol_coupl=1e-4,
                      innerRelDualTol_constr=1e-4)  # :125-135
    if overrides:
        opts = dataclasses.replace(opts, **overrides)
    state, out = fit(spec, data, state0, opts)
    if save_plots:
        from matlab_code_tpu_torch.utils.plotting import plot_convergence
        plot_convergence(out, path=save_plots,
                         title="convergence AO-ADMM (script 11, tPARAFAC2)")

    A_e = state.fac[0].detach().cpu().numpy()
    C_e = state.fac[2].detach().cpu().numpy()
    Bs = state.fac[1].detach().cpu().numpy()
    Bk_e = [Bs[k] for k in range(K)]
    num = sum(np.linalg.norm(slices[k] - A_e @ np.diag(C_e[k]) @ Bk_e[k].T,
                             "fro") ** 2 for k in range(K))
    den = sum(np.linalg.norm(slices[k], "fro") ** 2 for k in range(K))
    res = dict(fit=100.0 * (1.0 - num / den),
               fms_A=fms([A_e], [A_t]), fms_C=fms([C_e], [C_t]),
               fms_B=fms_par2_B(Bk_e, [B_t[k] for k in range(K)]),
               state=state, out=out)
    if verbose:
        print(f"Fit: {res['fit']:.2f}%  FMS_A: {res['fms_A']:.4f}  "
              f"FMS_B: {res['fms_B']:.4f}  FMS_C: {res['fms_C']:.4f}  "
              f"exit: {out.exit_flag}")
    return res


def build(small=False, eta=1000.0):
    K, J, I = (10, 20, 20) if small else (20, 50, 40)
    spec = ProblemSpec(
        mode_sizes=(I, (J,) * K, K),
        datasets=(DatasetSpec(model="PAR2", modes=(0, 1, 2), rank=3),),
        coupling=CouplingSpec(lin_coupled_modes=(0, 0, 0), coupling_type=()),
        constraints=(None, ConstraintSpec("tPARAFAC2", (eta,)),
                     ConstraintSpec("non-negativity")))
    opts = AlgOptions(MaxOuterIters=500 if small else 5000, MaxInnerIters=5,
                      AbsFuncTol=1e-14, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1]],
                distr=["randn", "rand", "rand+0.1"], opts=opts, key=2,
                bk_style="temporal", noise=0.05)


if __name__ == "__main__":
    if reference_path(FIXTURES, "noisy_dataset.mat"):
        run_real()
    else:
        run(**build())
