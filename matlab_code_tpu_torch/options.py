"""Algorithm and initialization options: plain copies of
matlab_code_tpu/options.py with the same fields, defaults and validation.

`matmul_precision` maps to torch's TF32 switches (apply_matmul_precision):
'default', 'float32' and 'highest' keep float32 products in full float32;
'tensorfloat32' enables TF32.  'bfloat16' on the CPU computes what
'default' computes, as jax.default_matmul_precision('bfloat16') leaves the
JAX package's CPU products alone; on a CUDA card it raises (BF16_ON_CUDA).
A fit scopes the setting to its call (scoped_matmul_precision), as the JAX
package's with_matmul_precision scopes jax's.  The default is full float32
because reduced-precision products put a floor under the flagship's
objective on the TPU (see AlgOptions.matmul_precision in the JAX package).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class LbfgsbOptions:
    """Mirrors the reference lbfgsb_options (example_script7:64-69)."""
    m: int = 5
    maxIts: int = 100
    maxTotalIts: int = 1000
    pgtol: float = 1e-4
    factr: float = 1e-6 / 2.220446049250313e-16


@dataclass(frozen=True)
class AlgOptions:
    Display: str = "no"                 # 'iter' | 'final' | 'no'
    DisplayIters: int = 10
    MaxOuterIters: int = 2000
    MaxInnerIters: int = 5
    AbsFuncTol: float = 1e-7
    OuterRelTol: float = 1e-8
    innerRelPrTol_coupl: float = 1e-5
    innerRelPrTol_constr: float = 1e-5
    innerRelDualTol_coupl: float = 1e-5
    innerRelDualTol_constr: float = 1e-5
    bsum: bool = False
    bsum_weight: float = 0.0
    eps_log: float = 1e-10
    iter_start_PAR2Bkconstraint: int = 0
    increase_factor_rhoBk: float | None = None
    lbfgsb: LbfgsbOptions = field(default_factory=LbfgsbOptions)
    # kept for field parity; the port's host loop records exact
    # per-iteration times and does not chunk
    TimeAtItChunk: int = 25
    # stop with 'illconditioned lin system' when the rcond estimate of an
    # assembled normal matrix (from its Cholesky diagonal) drops below this
    IllCondTol: float = 2.220446049250313e-16
    adaptive_rho_nonfrob: bool = False
    mesh_pipelined_collectives: bool = False
    par2_polar: str = "auto"
    # 'auto' = 'chol' on the CPU (the JAX CPU path's arithmetic) and
    # 'inverse' on CUDA (see PERF.md)
    inner_solve: str = "auto"
    # validated and kept for field parity; they choose nothing in the port:
    # on a CUDA card every sparse MTTKRP runs the hand-written kernel
    # (ops/sparse_cuda.py), which loads factor entries exactly (no bf16
    # passes), and on the CPU the plain version
    sparse_mttkrp: str = "auto"
    sparse_pallas_passes: int = 3
    matmul_precision: str = "default"

    def __post_init__(self):
        if self.par2_polar not in ("auto", "svd", "ns"):
            raise ValueError(f"par2_polar must be 'auto'|'svd'|'ns', "
                             f"got {self.par2_polar!r}")
        if self.inner_solve not in ("auto", "chol", "inverse", "newton"):
            raise ValueError(f"inner_solve must be 'auto'|'chol'|'inverse'"
                             f"|'newton', got {self.inner_solve!r}")
        if self.sparse_mttkrp not in ("auto", "gather", "pallas"):
            raise ValueError(f"sparse_mttkrp must be 'auto'|'gather'|"
                             f"'pallas', got {self.sparse_mttkrp!r}")
        if self.sparse_pallas_passes not in (1, 2, 3):
            raise ValueError(f"sparse_pallas_passes must be 1, 2 or 3, "
                             f"got {self.sparse_pallas_passes!r}")
        if self.Display not in ("iter", "final", "no"):
            raise ValueError(f"Display must be 'iter'|'final'|'no', "
                             f"got {self.Display!r}")
        if self.matmul_precision not in ("default", "bfloat16",
                                         "tensorfloat32", "float32",
                                         "highest"):
            raise ValueError(
                f"matmul_precision must be 'default'|'bfloat16'|"
                f"'tensorfloat32'|'float32'|'highest', "
                f"got {self.matmul_precision!r}")
    par2_polar_iters: int = 40
    cp_dimension_tree: bool = False
    cp_pairwise_perturbation: bool = False
    pp_start_tol: float = 0.02
    pp_refresh_tol: float = 0.05


# Why matmul_precision='bfloat16' raises on a card: chip_smoke.py phase 22,
# on an NVIDIA H100 80GB HBM3 at 700 W (torch 2.11): a 4096^2 float32 GEMM
# under 'medium' was 2.939e-04 off its float64 product, as under 'high'
# (TF32 inputs: 2.937e-04), where bfloat16 inputs give 2.350e-03.
BF16_ON_CUDA = (
    "matmul_precision='bfloat16' is not available on a CUDA card: torch "
    "has no bfloat16 mode for float32 GEMMs there; "
    "torch.set_float32_matmul_precision('medium') gives TF32 products "
    "(measured 2.9e-04 off float64 at 4096^2, as 'high', against 2.4e-03 "
    "for bfloat16 inputs; chip_smoke.py phase 22)")


def apply_matmul_precision(options: AlgOptions, device=None) -> None:
    """Set torch's float32 product precision for a fit on `device` (the
    card where None).  Both TF32 switches are set explicitly, so a fit
    never inherits cuDNN's TF32 default."""
    mp = options.matmul_precision
    if mp == "bfloat16" and torch.device(device or "cuda").type == "cuda":
        raise NotImplementedError(BF16_ON_CUDA)
    tf32 = mp == "tensorfloat32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@contextlib.contextmanager
def scoped_matmul_precision(options: AlgOptions, device=None):
    """The fit's precision (apply_matmul_precision) on `device` for the body
    of the with-block only: both TF32 switches are restored as the caller
    left them on exit, a raise included (the counterpart of the JAX
    package's with_matmul_precision)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        apply_matmul_precision(options, device)
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclass(frozen=True)
class InitOptions:
    """Initialization config (init_coupled_AOADMM_CMTF.m:16-20).  distr[m]:
    'rand' | 'randn' | 'rand+0.1', or a callable (generator, shape, dtype,
    device) -> tensor."""
    distr: tuple = ()
    normalize: bool = True
    nvecs: bool = False
    lambdas_init: tuple = ()
