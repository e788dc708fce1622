"""matlab_code_tpu_torch — the PyTorch + CUDA port of matlab_code_tpu, the
AO-ADMM framework for constrained, regularized and linearly coupled
matrix/tensor factorizations.

It mirrors the JAX package's layout (ops/, models/, utils/) and function
names, imports torch and never jax, and carries the main path so far: CP
datasets with Frobenius loss, coupling types 0 and 4, and the
'non-negativity', 'box' and 'non-negative l2-sphere' constraints.  Every
dense 3-way MTTKRP on a CUDA tensor runs the hand-written Hopper kernel
ops/mttkrp_cuda.mttkrp3 (csrc/mttkrp3.cu).  What is not ported yet raises
NotImplementedError naming its slice in ROADMAP.md.
"""

from matlab_code_tpu_torch.problem import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, ProblemData,
    check_data_input,
)
from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.state import SolverState
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit

__all__ = [
    "ProblemSpec", "DatasetSpec", "CouplingSpec", "ConstraintSpec",
    "ProblemData", "AlgOptions", "InitOptions", "SolverState",
    "init_coupled", "cmtf_aoadmm", "fit", "check_data_input",
]
