"""Example 7: 3-way CP (50x30x40) + matrix (50x70), Poisson count data, KL
divergence loss for both (L-BFGS-B factor subproblems), exact coupling of
mode 0/3, no constraints.  Port of example_script7_matrix_CP_KLdivergence.m
(sizes :21, loss :40-41, lbfgsb options :64-69, options :95-107).
Counterpart of examples/script07_matrix_cp_kl.py on the port."""
from matlab_code_tpu_torch import (
    ProblemSpec, DatasetSpec, CouplingSpec, AlgOptions)
from matlab_code_tpu_torch.options import LbfgsbOptions
from matlab_code_tpu_torch.examples.common import run


def build(small=False):
    spec = ProblemSpec(
        mode_sizes=(50, 30, 40, 50, 70),
        datasets=(DatasetSpec(model="CP", modes=(0, 1, 2), rank=3, weight=0.5,
                              loss="KL"),
                  DatasetSpec(model="CP", modes=(3, 4), rank=3, weight=0.5,
                              loss="KL")),
        coupling=CouplingSpec(lin_coupled_modes=(1, 0, 0, 1, 0),
                              coupling_type=(0,)),
        constraints=(None,) * 5)
    opts = AlgOptions(MaxOuterIters=400 if small else 4000, MaxInnerIters=5,
                      AbsFuncTol=1e-4, OuterRelTol=1e-6,
                      innerRelPrTol_coupl=1e-3, innerRelPrTol_constr=1e-3,
                      innerRelDualTol_coupl=1e-3, innerRelDualTol_constr=1e-3,
                      lbfgsb=LbfgsbOptions(m=5, maxIts=100, pgtol=1e-4))
    return dict(spec=spec, lambdas=[[1, 1, 1], [1, 1, 1]],
                distr=[("gamma", 1.0, 1.0)] * 5, init_distr=["rand"] * 5,
                opts=opts, key=2, normalize=False)


if __name__ == "__main__":
    run(**build())
