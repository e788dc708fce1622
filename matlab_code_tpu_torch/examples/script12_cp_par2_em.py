"""Example 12: CP (20x30x40) + PARAFAC2 (20 x 25*30 x 30) exactly coupled on
mode 0/3, with 20% missing-at-random entries in both datasets, recovered by
EM imputation.  Port of example_script12_CP_PAR2_EM.m (sizes :34,
coupling :45, missing setup :115-147).
Counterpart of examples/script12_cp_par2_em.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, AlgOptions)
from matlab_code_tpu_torch.examples.common import run


def build(small=False):
    K, J = (8, 15) if small else (30, 25)
    spec = ProblemSpec(
        mode_sizes=(20, 30, 40, 20, (J,) * K, K),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5),
                  DatasetSpec(model="PAR2", modes=(3, 4, 5), rank=3,
                              weight=0.5)),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0, 0),
                              coupling_type=(0,)),
        constraints=(None,) * 6)
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-7, OuterRelTol=1e-8)
    return dict(spec=spec, lambdas=[[1, 1, 1], [1, 1, 1]],
                distr=["randn", "randn", "randn", "randn", "randn",
                       "rand+0.1"],
                opts=opts, key=2, miss_fraction=0.2)


def _reference_masks(data, rng):
    """Replay example_script12's missing-mask construction (:115-147):
    miss_mask(randperm(n, round(0.2*n))) = false with MATLAB's linear
    (column-major) indexing, one call for the CP block and one per PAR2
    slice, then the masked entries of the (already normalized) data are
    set to 0 (:143-147).  The masks are drawn on the host; the data and
    masks stay on the data's device."""
    import dataclasses
    import numpy as np
    import torch
    from matlab_code_tpu_torch import Parafac2Tensor

    def mround(x):                       # MATLAB round: half away from zero
        return int(np.floor(x + 0.5))

    X0 = data.objects[0]
    n = X0.numel()
    m = np.ones(n, bool)
    m[rng.randperm(n, mround(0.2 * n)) - 1] = False
    mask_cp = m.reshape(tuple(X0.shape), order="F")

    Xp = data.objects[1]
    K, I, _ = Xp.slices.shape
    sizes = Xp.mask.sum(dim=1).tolist()
    mask_p2 = np.ones(tuple(Xp.slices.shape), bool)
    for k in range(K):
        J = int(sizes[k])
        nk = I * J
        mk = np.ones(nk, bool)
        mk[rng.randperm(nk, mround(0.2 * nk)) - 1] = False
        mask_p2[k, :, :J] = mk.reshape((I, J), order="F")

    dev = X0.device       # row-major masks, as the data are
    mask_cp = torch.tensor(np.ascontiguousarray(mask_cp), device=dev)
    mask_p2 = torch.tensor(mask_p2, device=dev)
    zero = torch.zeros((), dtype=X0.dtype, device=dev)
    objects = (torch.where(mask_cp, X0, zero),
               Parafac2Tensor(torch.where(mask_p2, Xp.slices, zero),
                              Xp.mask))
    return dataclasses.replace(data, objects=objects,
                               miss=(mask_cp, mask_p2))


def run_reference(verbose=True, device=None, dtype=None, **overrides):
    """Reference-seeded replay of example_script12: data regenerated
    with the rng("default") draw sequence of
    create_coupled_data.m (all-randn factors, shift-PARAFAC Bk, noise
    0.05), normalized, then the ~20% missing masks drawn from the same
    stream via randperm (example_script12:115-147; see MatlabRNG.randperm
    for the anchors that pin it), then init on the same stream.  EM imputation recovers the held-out entries."""
    from matlab_code_tpu_torch.examples.common import run_reference_seeded
    cfg = build()
    return run_reference_seeded(
        cfg["spec"], cfg["lambdas"], cfg["distr"], cfg["opts"],
        noise=0.05, pre_init=_reference_masks, verbose=verbose,
        device=device, dtype=dtype, overrides=overrides)


if __name__ == "__main__":
    run(**build())
