"""matlab_code_tpu_torch — the PyTorch + CUDA port of matlab_code_tpu, the
AO-ADMM framework for constrained, regularized and linearly coupled
matrix/tensor factorizations.

It mirrors the JAX package's layout (ops/, models/, utils/) and function
names, imports torch and never jax, and carries these paths so far: CP
datasets, dense or sparse COO (SparseTensor), and PARAFAC2 datasets
(Parafac2Tensor, regular or ragged slices), with Frobenius loss, dense CP
datasets with KL, Itakura-Saito or beta-divergence loss (L-BFGS-B factor
steps), coupling types 0-5, every constraint and regularizer, random or
nvecs init, EM imputation of missing entries, the pairwise-perturbation
MTTKRP (models/pairwise.py), fit_stepwise, checkpoints
(utils/checkpoint.py) and fit_multistart (models/multistart.py: the
starts on one start axis under torch.func.vmap).  On a CUDA card every
dense 3-way MTTKRP runs the hand-written Hopper kernel ops/mttkrp_cuda.mttkrp3 (csrc/mttkrp3.cu),
every sparse MTTKRP the hand-written kernel ops/sparse_cuda.
mttkrp_sparse_cuda (csrc/mttkrp_sparse.cu), the sequential proxes the
kernels of ops/prox_cuda (csrc/prox_seq.cu, csrc/t_smooth.cu), and the
non-Frobenius loss pass ops/loss_cuda.loss_fg_cuda (csrc/loss_fg.cu).
The user surface needs no jax either: create_coupled_data and the
MATLAB-seeded generators (utils/datagen.py, utils/matlab_rng.py), FMS and
Fit% (utils/score.py), and the 16 example configurations with their runner
(examples/, python -m matlab_code_tpu_torch.examples.run_all).
"""

from matlab_code_tpu_torch.problem import (
    ProblemSpec, DatasetSpec, CouplingSpec, ConstraintSpec, ProblemData,
    SparseTensor, Parafac2Tensor, check_data_input,
)
from matlab_code_tpu_torch.options import AlgOptions, InitOptions
from matlab_code_tpu_torch.state import SolverState
from matlab_code_tpu_torch.models.init import init_coupled
from matlab_code_tpu_torch.models.pairwise import eligible_pp_datasets
from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit, fit_stepwise
from matlab_code_tpu_torch.models.multistart import fit_multistart
from matlab_code_tpu_torch.utils.checkpoint import load_state, save_state
from matlab_code_tpu_torch.utils.datagen import create_coupled_data

__all__ = [
    "ProblemSpec", "DatasetSpec", "CouplingSpec", "ConstraintSpec",
    "ProblemData", "SparseTensor", "Parafac2Tensor", "AlgOptions",
    "InitOptions", "SolverState",
    "init_coupled", "cmtf_aoadmm", "fit", "fit_stepwise", "fit_multistart",
    "eligible_pp_datasets", "save_state", "load_state", "check_data_input",
    "create_coupled_data",
]
