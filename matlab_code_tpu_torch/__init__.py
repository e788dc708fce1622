"""matlab_code_tpu_torch — the PyTorch + CUDA port of matlab_code_tpu, the
AO-ADMM framework for constrained, regularized and linearly coupled
matrix/tensor factorizations.

It mirrors the JAX package's layout (ops/, models/, utils/) and function
names, imports torch and never jax, and carries these paths so far: CP
datasets, dense or sparse COO (SparseTensor), and PARAFAC2 datasets
(Parafac2Tensor, regular or ragged slices), with Frobenius loss, coupling
types 0-5, every constraint and regularizer, random or nvecs init.  On a
CUDA card every dense 3-way MTTKRP runs the hand-written Hopper kernel
ops/mttkrp_cuda.mttkrp3 (csrc/mttkrp3.cu), every sparse MTTKRP the
hand-written kernel ops/sparse_cuda.mttkrp_sparse_cuda
(csrc/mttkrp_sparse.cu), and the sequential proxes the kernels of
ops/prox_cuda (csrc/prox_seq.cu, csrc/t_smooth.cu).  What is not ported
yet raises NotImplementedError naming its slice in ROADMAP.md.
"""

from matlab_code_tpu_torch.problem import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, ProblemData,
    SparseTensor, Parafac2Tensor, check_data_input,
)
from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.state import SolverState
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit

__all__ = [
    "ProblemSpec", "DatasetSpec", "CouplingSpec", "ConstraintSpec",
    "ProblemData", "SparseTensor", "Parafac2Tensor", "AlgOptions",
    "InitOptions", "SolverState",
    "init_coupled", "cmtf_aoadmm", "fit", "check_data_input",
]
