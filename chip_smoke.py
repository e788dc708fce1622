#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (matlab_code_tpu_torch) on one
NVIDIA GPU.  Usage, from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together, into the git-ignored matlab_code_tpu_torch/_build/) and
runs twenty-four phases, each printing its seconds; any failure raises
and exits non-zero:

  1. device and precision: the card, its power limit, the TF32 switches;
  2. dense kernel vs plain: the MTTKRP kernels (the rows-stream kernel of
     modes 0 and 1, the stream kernel of mode 2) against their plain
     PyTorch version in float64 on the card, at the flagship's two tensor
     shapes, at ragged shapes (K = 1, K = 29, odd K, one at R 40: two
     column blocks) and at bench.py's HBM-resident 256x1024x512 X, with X
     also in float16 and bfloat16 and, at the timed shapes, one element
     off an aligned pointer; prints each plan and its partial bytes;
     times every mode against torch.einsum, its bound and one plain read
     of X (X.sum()) after the same flush, and runs a design probe of each
     kernel (tile rows, ring depth, stage size, copy route);
  3. the full-size flagship fit (bench.py's workload: three CP datasets,
     type-4 selector coupling, all modes non-negative) through cmtf_aoadmm
     for 300 outer iterations in float32, counting the kernel's launches;
  4. card vs CPU: the first 5 outer iterations from one init state, on the
     card in float32 and on the CPU in float64 (plain path);
  5. fit to tolerance (AbsFuncTol 1e-4, OuterRelTol 1e-10, at most 2000
     iterations) from phase 3's init state, with the kernel in
     float32, with the plain version in float32 and with the kernel in
     float64 (at most 1000 iterations): a measurement that does not gate
     the result;
  6. sparse kernels vs plain: the sparse COO MTTKRP kernels (the fiber
     kernel the plans name for these shapes and the chunk kernel; modes 0,
     1, 2, float32 and float64) against their plain version on the card,
     at the sparse workload's size (bench_large.py's: ~1e7 nonzeros of a
     2048^3 tensor, R 16), at ragged shapes, at a case with duplicates,
     empty rows, a row of many chunks and R 40, and at a shape too large
     for the fiber kernel's tile in mode 0; times both kernels vs plain,
     and at R 8 and R 32;
  7. the full-size sparse CP fit through cmtf_aoadmm for 50 outer
     iterations in float32, counting the sparse kernel's launches;
  8. card vs CPU on the sparse path: the first 3 outer iterations from one
     init state, on the card in float32 and on the CPU in float64;
  9. the sequential-prox kernels vs plain (csrc/prox_seq.cu): kernel A
     (non-decreasing, non-increasing, unimodal with and without
     non-negativity) and kernel B (TV) at n in {1, 2, 29, 256, 512, 1024,
     4096} and R in {1, 16, 20, 40}, float32 and float64, with constant
     columns, ties, all-negative columns, lam = 0 and lam above each
     column's TV, against the plain version in float64 (float64 rtol 1e-12,
     float32 rtol 1e-5); these take each kernel's shared route (its state
     in shared memory), and one case past each shared route's limit (A at
     8192x3, B at 20480x2) its global route (the same kernel, its state in
     device memory).  The plain version reads every value on the host
     and syncs on every step, so it runs on the CPU (its time, on the
     host clock, is the kernels line's plain_ms).  Times both kernels'
     two routes in turns (global, shared, shared, global; the same bits
     from both) at 512x16, 256x16 and 4096x20 beside their bound (a
     column's n dependent steps at one a clock of the card's maximum SM
     clock, or the bytes at 3.35 TB/s), and runs every other new prox
     kind on a 4096x20 card tensor against the CPU in float64;
 10. the CP surface at full size (utils/surface.py: the flagship's three
     datasets under coupling types 1, 2, 3 and 5, with unimodal, TV, GL
     smoothness, simplex and l1 constraints): for each type 20 outer
     iterations through cmtf_aoadmm in float32 on the card (ms per
     iteration, launches of the three kernels and of A's and B's routes,
     host syncs, peak memory),
     3 outer iterations under torch.profiler (device time by kernel, the
     device's busy share), then the first 3 outer iterations from one init
     state on the card and on the CPU in float64, held to rtol 1e-8.

 11. the slice-wise kernels vs plain: kernels A and B on (K, n, R) stacks
     of PARAFAC2 slices (one launch for every slice; B with one lam a
     slice, 0 among them) at the PAR2 workload's (512, 256, 32), at (1,
     256, 32), (2, 29, 5), (3, 256, 32) and (7, 29, 5) (K R not a multiple
     of 32), on their planned route and on the lanes route (a thread a
     column, a warp 32 columns), and on a ragged stack of 64 slices through
     prox_slicewise_ragged (one lanes launch a call, padded rows zero), and
     kernel C (csrc/t_smooth.cu, the tPARAFAC2 prox; both routes: a tile
     staged in shared memory, or r' streamed through the output; one warp
     walks the recurrence beside the walkers) at (512, 256, 32) and K in
     {1, 2, 3}, against their plain versions (float64: the same bits;
     float32 those rounded once, kernel C the same bits, also on wide
     operands: B across 2^+-60 with zeros and subnormals, rho in [1e-6,
     1e6], eta 1e-3, 1 and 1e6), each timed after the L2 flush beside its
     bound: A and B's lanes route against the block route (a block a
     column) in turns (lanes, block, block, lanes), kernel C's routes in
     turns in float32 and float64 with its recurrence alone (the floor),
     and torch.linalg.solve of kernel C's dense K x K system as its
     library call;
 12. the PAR2 K=512 workload (bench.py:235-263, utils/par2_workload.py:
     512 slices of 256 x 256, rank 32, non-negative A and C) through
     cmtf_aoadmm for 100 outer iterations in float32 (ms per iteration,
     median and p90, peak memory, host syncs and launches an iteration, the
     device's busy share under torch.profiler), one outer sweep timed under
     each par2_polar ('svd', 'ns') and inner_solve ('chol', 'inverse',
     'newton'), and the first 3 iterations on the card and on the CPU in
     float64 at K = PAR2_CPU_K, held to rtol 1e-8;
 13. the PARAFAC2 surface (utils/par2_surface.py: unimodal Bk switched on at
     iteration 10, TV Bk, tPARAFAC2 Bk, ragged unimodal Bk, and the PAR2
     dataset coupled with a CP tensor by types 0 and 1), 20 outer
     iterations each in float32 (ms per iteration, the launches of kernels
     A, B, C and mttkrp3 and of A's and B's routes; the ragged stack's
     launches of A an iteration, one a prox call), then the first 3
     iterations on the card and on the CPU in float64 at K = PAR2_CPU_K,
     held to rtol 1e-8;
 14. kernel D against its plain version on the card, for KL, IS and beta
     at 0.5 and 1.5 in float32 and float64 (csrc/loss_fg.cu): the old
     pass (sum fh and gh from a given model) at the KL workload's
     128x256x256 and at an odd length (gh within 1e-6 / 1e-12 of the sum
     of its two terms' magnitudes, sum fh within 1e-5 / 1e-12, the same
     bits on repeat), and the fused evaluation (sum fh and the MTTKRP of
     gh, the model formed in the kernel) in modes 0-2 and f alone at
     128x256x256 R 8, 37x50x29 R 3, 8 and 40, 1x1x1 and 5x3x130 (G within
     1e-5 / 1e-12 of the MTTKRP of |gh's terms| and |factors|, sum fh
     within 1e-5 / 1e-12, the same bits on repeat; three starts in one
     launch, X shared and one a start, each start the bits of its own
     launch); both timed at the workload's data and init beside their
     bounds, their plain versions, the three-call evaluation the fused
     one replaces (torch.einsum's model, the old pass, mttkrp3) and its
     parts; the fused call against the three-call evaluation at R 8, 40
     and 64 in float32 and float64, modes 0-2, CUDA events and
     torch.profiler device time (utils/time_fused.py, the ground of
     losses.takes_fused's route), and at R 8 the fused beta-2 call (no
     division, no log), the f-only pass and X.sum();
 15. the KL workload (bench_large.py:116-139, utils/kl_workload.py:
     128x256x256 Poisson counts, rank 8, non-negative, KL) through
     cmtf_aoadmm for 5 outer iterations in float32 (ms an iteration,
     median and p90, the device reads an iteration and their share of the
     wall clock, the L-BFGS-B evaluations and the fused kernel's launches,
     which must be one an evaluation and one an objective pass with no
     old pass, no mttkrp3 and no model by torch.einsum, the L-BFGS-B
     iterations, peak memory, the device's busy share under
     torch.profiler) and in float64, then example script 07's configuration at its
     widths (a 50x30x40 tensor and a 50x70 matrix, both KL, coupled by
     type 0) for 3 iterations on the card and on the CPU in float64: the
     streams at rtol 1e-8, the inner and L-BFGS-B iteration counts equal,
     the tensor's evaluations one fused launch each, the matrix's the old
     pass;
 16. EM imputation (utils/em_workload.py): the flagship with 20 % of every
     dataset missing at random for 100 outer iterations and the PAR2 K=512
     workload with 20 % missing for 20, through cmtf_aoadmm in float32 (ms
     an iteration, median and p90, host syncs and mttkrp3 launches an
     iteration, every one on a freshly imputed tensor, peak memory, the
     func_rel_missing stream, the device's busy share under
     torch.profiler), then example script 12's widths (CP and PARAFAC2, 20 %
     missing, type 0) for 3 iterations on the card and on the CPU in
     float64: the five streams at rtol 1e-8, the inner iterations equal;
 17. the pairwise-perturbation MTTKRP (models/pairwise.py) at its default
     tolerances: the flagship for 300 iterations and the sparse workload for
     50, each against the exact fit in turns (exact, PP, PP, exact): ms an
     iteration, the first approximated sweep, the approximated sweeps, the
     rebuilds, the launches of mttkrp3 or the sparse kernel, the exact final
     f_tensors against the exact fit's; then a small dense and a small COO
     problem with PP for 40 iterations on the card and on the CPU in
     float64: the streams at rtol 1e-8, the same gate decisions;
 18. fit_stepwise against fit on the flagship from one init for 20
     iterations in float32 (the same iterations, inner iterations and
     streams, non-decreasing wall times), and save_state of the card state
     after 10 iterations read back by load_state: every field bit-equal and
     on the card;
 19. fit_multistart (models/multistart.py): one mttkrp3 call with 20
     starts' columns side by side at the flagship's shapes against each
     start's plain MTTKRP in float64 (and timed against 20 calls of one
     start's width); the flagship with 20 starts for 30 outer iterations
     in float32 in turns with one start's fit (ms an iteration, host reads
     and mttkrp3 launches an iteration, peak memory), 3 iterations of each
     under torch.profiler (the device's busy share); then example script
     15's widths with 4 starts for 3 iterations in float64 on the card
     against the CPU, and each card start against its own card fit: the
     streams at rtol 1e-8, the inner iterations equal;
 20. fit_multistart for the other losses, sparse COO data and the pairwise
     option: (c) kernel D on the start axis, one launch for 20 starts at
     the KL workload's shape in float32 and float64, against its plain
     version and against 20 single-start launches (each start's f and Y
     bit for bit), timed against them, and the same for the fused
     evaluation (20 starts sharing X, rank 8, modes 0-2, f and G bit for
     bit); (a) the KL workload with 20 starts
     for 5 iterations in float32 in turns with one start's fit (ms an
     iteration, host reads, the fused kernel's launches, one an
     evaluation for every start, no old pass, mttkrp3 or model by
     torch.einsum, peak memory, the best start's L-BFGS-B iterations; 2
     iterations of each under torch.profiler); (b) the sparse workload: one sparse-kernel
     call of 20 starts' columns a mode against 20 single-start calls
     (float32 and float64, the partial sums' bytes beside the card's
     memory), then 20 starts for 10 iterations in turns with one start's
     fit (one launch a mode an iteration for all starts); (d) script 07's
     widths with 4 starts for 3 iterations in float64: the card's lanes
     against the CPU's and each against its own card fit within 1e-12,
     inner and L-BFGS-B iterations equal, the fused kernel and the old pass
     launched; (e) the flagship with 4 starts
     for 10 iterations with cp_pairwise_perturbation: the finals of the
     run without it (the JAX function's exact MTTKRPs);
 21. the examples (matlab_code_tpu_torch/examples/): (a) the 13
     reference-seeded replays, data and init drawn by the port on the
     MATLAB twister stream, 10 outer iterations in float64 on the card and
     on the CPU: func_val_conv at rtol 1e-8, each final factor within 1e-8
     of its largest entry, innerIters equal (a PARAFAC2 replay that misses
     takes par2_polar='svd' on the card, the CPU's 'auto'); (b) the 16
     configurations of build(small=False) at the scripts' widths in
     float32, two at a time in worker processes sharing the card, 100
     outer iterations at most (script 09: 120, its Bk constraint from
     iteration 100; script 15: 20 starts, 30): finite streams, Fit% and
     FMS, iterations, exit flag, median ms an iteration (script 09's
     constrained iterations apart), and the launches of mttkrp3 (every
     script with a 3-way Frobenius CP dataset), of the fused kernel D
     (a 3-way KL, IS or beta one: script 07) and of kernels D, A, B and C
     (scripts 07, 09, 10, 11), each counted from zero before its script,
     kernel A in every constrained iteration of script 09; the phase
     fails past 150 s;
 22. matmul_precision='bfloat16': a 4096^2 float32 GEMM under torch's
     'highest', 'high' and 'medium' float32 matmul precision against its
     float64 product (relative error, time), beside the errors of inputs
     rounded to bfloat16 and to TF32, and options.py's decision for
     'bfloat16' on the card, which must match what 'medium' gives;
 23. the mesh (matlab_code_tpu_torch/parallel/), in spawned worker
     processes: (a) one rank over a real NCCL communicator: the full-width
     flagship and the sparse workload through cmtf_aoadmm(mesh=) for 10
     iterations in float32 against the plain card fit (the same bits or
     not, ms an iteration); (b) two ranks sharing the card over gloo: the
     flagship (bulk and ring collectives) and the sparse workload in
     float64 for 10 iterations, each rank's mttkrp3 or sparse kernel on its
     half, against the plain card fit at rtol 1e-10, the KL workload for 3
     (kernel D on each block; within 10x the gap a one-ulp change of the
     data makes to the plain card fit), fit_multistart of the flagship with 20
     starts split 10 and 10 against the unsharded port; every rank's state
     bit-equal, each rank's launches, collectives and host-staging time;
     fails past 120 s;
 24. a PARAFAC2 dataset cut along K over the mesh (its slices, Bk, P and
     mu_DeltaB the rank's, C replicated), in spawned worker processes: (a)
     one NCCL rank, the PAR2 K=512 workload through cmtf_aoadmm(mesh=) for
     10 iterations in float32 against the plain card fit (its factor and
     stream bits), and utils/profiling.roofline_report of the plain fit;
     (b) two gloo ranks sharing the card, 256 slices a rank, float64, 4
     iterations: the PAR2 K=512 workload and the PARAFAC2 surface's
     tparafac2 (replicated by fit(mesh=): kernel C), ragged (kernel A),
     tv (kernel B) and coupled (mttkrp3, the par2C kron system)
     configurations against the plain card fit (the first iteration within
     1e-12, the run's f_tensors within 1e-8 and its factors within 1e-4
     of their largest entry), every rank's state bit-equal, the fit's own
     launches (the init drawn before the counts are set to 0), collectives,
     host staging and ms an iteration, each configuration again laid out
     by hand with every PARAFAC2 dataset replicated (the layout before the
     K-cut), and tparafac2 cut along K (kernel C on the gathered stack),
     under the same checks, the layouts' ms side by side; one
     utils/profiling.torch_trace of a 2-iteration plain PAR2 fit, written
     and read back; fails past 120 s.

It then prints one JSON line describing the seven kernels (mttkrp3's and
the sparse kernel's launches on phases 16-17's paths beside them,
mttkrp3's on phase 19's, kernel D's (both forms) and the sparse kernel's
on phase 20's, kernel D's start-axis times, and every kernel's launches on
phase 21 (b), "examples_launches", and on phase 23's and 24's mesh runs,
"mesh_launches"; the fused kernel D's launches are phase 15's KL
workload's, the old pass's script 07's, whose matrix takes it),
the card's name
and power limit, and as its last line {"ok": true, "device": {...}}.  It
imports nothing of JAX, and it fails without a CUDA card or without the
package beside it.
"""
import dataclasses
import functools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "matlab_code_tpu_torch/csrc/mttkrp3.cu"
REPLACES = "matlab_code_tpu/ops/mttkrp_pallas.py:60"
SPARSE_SOURCE = "matlab_code_tpu_torch/csrc/mttkrp_sparse.cu"
SPARSE_REPLACES = "matlab_code_tpu/ops/sparse_pallas.py:300"
FLAGSHIP_SHAPES = (((128, 512, 256), 16), ((128, 1024, 64), 20))
RAGGED_SHAPES = (((37, 50, 29), 7), ((5, 3, 130), 1), ((37, 50, 29), 40),
                 ((40, 30, 1), 5), ((7, 9, 31), 20))
HBM_SHAPE = ((256, 1024, 512), 16)   # bench.py:199-210, X 537 MB
FIT_ITERS = 300
CPU_ITERS = 5
TOL_ITERS = 2000
# phase 5's float64 leg: it passes both TOL_MARKS by iteration 950 and has
# not reached the tolerance at 2000 (86 s of the script's time limit), so
# it stops here
TOL_ITERS_F64 = 1000
TOL_MARKS = (2e-4, 1.6e-4)   # f_tensors levels whose first iteration is shown
# (shape, draws, R, duplicated draws, extra nonzeros in row 0)
SPARSE_RAGGED = (((300, 257, 129), 20000, 7, 0, 0),
                 ((40, 23, 17), 3000, 40, 500, 3072),
                 ((64, 70000, 60000), 20000, 16, 0, 0))
SPARSE_ITERS = 50
SPARSE_CPU_ITERS = 3
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
PROX_SOURCE = "matlab_code_tpu_torch/csrc/prox_seq.cu"
ISOTONIC_REPLACES = ("matlab_code_tpu/ops/isotonic.py:23-147 (lax loop, no "
                     "pallas_call)")
TV_REPLACES = "matlab_code_tpu/ops/tv.py:23-126 (lax loop, no pallas_call)"
PROX_NS = (1, 2, 29, 256, 512, 1024, 4096)
PROX_RS = (1, 16, 20, 40)
# (n, R) the kernels are timed at: X0's 512 and 256 modes at R 16, and
# the flagship's widest mode at R 20
PROX_TIMED = ((512, 16), (256, 16), (4096, 20))
# (n, R) past each shared route's limit: kernel A's global route, kernel B's
PROX_LONG_A, PROX_LONG_B = (8192, 3), (20480, 2)
SURFACE_ITERS = 20
SURFACE_CPU_ITERS = 3
T_SMOOTH_SOURCE = "matlab_code_tpu_torch/csrc/t_smooth.cu"
T_SMOOTH_REPLACES = ("matlab_code_tpu/ops/prox.py:144-188 (two lax.scans, "
                     "no pallas_call)")
PAR2_SHAPE = (512, 256, 32)     # (K, J, R) of the PAR2 K=512 workload
PAR2_ITERS = 100
PAR2_CPU_K = 16                 # slices of the card-vs-CPU float64 runs
PAR2_CPU_ITERS = 3
LOSS_SOURCE = "matlab_code_tpu_torch/csrc/loss_fg.cu"
LOSS_REPLACES = ("matlab_code_tpu/models/lbfgs_bridge.py:45-47 and "
                 "matlab_code_tpu/models/objective.py:84-87 (fused by XLA, "
                 "no pallas_call)")
LOSS_CASES = (("KL", None), ("IS", None), ("beta", 0.5), ("beta", 1.5))
LOSS_SHAPES = ((128, 256, 256), (1000003,))   # the workload's; an odd length
# (float32, float64) tolerances of kernel D against its plain version: gh
# (a difference of two terms) against the sum of the terms' magnitudes,
# sum fh relative (summed in another order)
LOSS_RTOL_GH = (1e-6, 1e-12)
LOSS_RTOL_F = (1e-5, 1e-12)
FUSED_SOURCE = "matlab_code_tpu_torch/csrc/loss_fg.cu"
FUSED_REPLACES = ("matlab_code_tpu/models/lbfgs_bridge.py:41-49 and "
                  "matlab_code_tpu/models/objective.py:84-87 (fused by XLA, "
                  "no pallas_call)")
# (shape, ranks) the fused kernel D is held to its plain version at: the KL
# workload's and odd ones
FUSED_SHAPES = (((128, 256, 256), (8,)), ((37, 50, 29), (3, 8, 40)),
                ((1, 1, 1), (3,)), ((5, 3, 130), (8,)))
# (float32, float64) tolerance of the fused kernel's G against its plain
# version, of the MTTKRP of |gh's two terms| and |factors|: each entry sums
# J K (or I K, I J) terms in another order than torch.einsum, of a gh whose
# model is summed in another order too; its f is held to LOSS_RTOL_F
FUSED_RTOL_G = (1e-5, 1e-12)
# ranks the fused call is timed at against the three-call evaluation, in
# float32 and float64, at the KL workload's shape (phase 14)
FUSED_TIMED_RANKS = (8, 16, 32, 40, 64)
KL_ITERS = 5
S07_ITERS = 3
S07_SEED = 2
EM_ITERS = 100          # the EM flagship (utils/em_workload.py)
EM_PAR2_ITERS = 20      # the EM PAR2 K=512 workload
EM_CPU_ITERS = 3        # script 12's widths, card against CPU
PP_ITERS = 300          # the flagship with the pairwise perturbation
PP_SPARSE_ITERS = 50    # the sparse workload with it
PP_SMALL_ITERS = 40     # the small problems, card against CPU
STEP_ITERS = 20         # fit_stepwise against fit on the flagship
CKPT_ITERS = 10         # the state checkpointed
MS_STARTS = 20          # fit_multistart on the flagship (example_script15:113)
MS_ITERS = 30
MS_S15_STARTS = 4       # script 15's widths, card against CPU
MS_S15_ITERS = 3
MS_KL_ITERS = 5         # fit_multistart on the KL workload, 20 starts
MS_SPARSE_ITERS = 10    # and on the sparse workload
MS_S07_ITERS = 3        # script 07's widths, 4 starts, card against CPU
MS_PP_STARTS = 4        # the flagship with cp_pairwise_perturbation
MS_PP_ITERS = 10
EXAMPLE_REPLAY_ITERS = 10   # the 13 replays, card against CPU in float64
EXAMPLE_ITERS = 100         # the 16 configurations at full width
EXAMPLE_S09_ITERS = 120     # script 09: its Bk constraint from iteration 100
EXAMPLE_S15_ITERS = 30      # script 15: 20 starts
EXAMPLE_WORKERS = 2         # processes that share the card for (b)
EXAMPLE_PHASE_S = 150       # phase 21 fails past this many seconds
BF16_N = 4096               # the GEMM of phase 22
MESH_ITERS = 10             # phase 23: fits over a mesh
MESH_KL_ITERS = 3
MESH_STARTS = 20            # fit_multistart over 2 ranks, 10 starts a rank
MESH_RTOL = 1e-10           # (b)'s float64 runs against the plain card fit
# (b)'s KL run is held within this many times the gap a one-ulp change of
# the data makes to the plain card fit: in float64 its L-BFGS-B solves carry
# a 1e-16 change of f or g to ~1e-4 in three iterations; never past
# MESH_KL_CAP (f_tensors, factors), whatever the yardstick gives
MESH_KL_SLACK = 10.0
MESH_KL_CAP = (1e-3, 2e-2)
# where that chaos has not begun: each KL mode's first L-BFGS-B evaluation
# (f and gradient) at the init state, over the mesh against the plain one
MESH_KL_EVAL_RTOL = 1e-12
MESH_KL_EVAL_RHO = 1.0
MESH_PHASE_S = 120          # phase 23 fails past this many seconds
# phase 24: PARAFAC2 cut along K.  (a)'s float32 runs take MESH_ITERS
# iterations, (b)'s float64 runs MESH_PAR2_ITERS
MESH_PAR2_ITERS = 4
# (b) against the plain card fit: the first iteration's f_tensors and
# f_PAR2_couplings within MESH_PAR2_FIRST_RTOL (only the order of the sums
# over K differs), the whole run's f_tensors within MESH_PAR2_RUN[0] and
# every factor within MESH_PAR2_RUN[1] of its largest entry: the ragged
# configuration is ill-conditioned in Bk (tests/test_mesh_coupled.py holds
# its factors at atol 1e-4)
MESH_PAR2_FIRST_RTOL = 1e-12
MESH_PAR2_RUN = (1e-8, 1e-4)
MESH_PAR2_CONFIGS = ("tparafac2", "ragged", "tv", "coupled")
MESH_PAR2_NEED = {"par2": [], "par2-tparafac2": ["C"], "par2-ragged": ["A"],
                  "par2-tv": ["B"], "par2-coupled": ["mttkrp3"]}
# (b) runs each job over the mesh in fit(mesh=)'s own layout (the K-cut,
# tPARAFAC2 replicated) and again laid out by hand (a job name
# '<job>+<par2>', sharding.data_shardings(par2=...)): every job with every
# PARAFAC2 dataset replicated (the layout before the K-cut), the tparafac2
# one cut along K too (the JAX package's rule, kernel C on the gathered
# stack); each held to the same bounds.  The launches of fit(mesh=)'s own
# runs go into the kernels line
MESH_PAR2_BY_HAND = {"replicated": ("par2",) + tuple(
    f"par2-{c}" for c in MESH_PAR2_CONFIGS), "cut": ("par2-tparafac2",)}
TRACE_ITERS = 2             # the torch_trace of a plain PAR2 fit
MESH_PAR2_PHASE_S = 120     # phase 24 fails past this many seconds


def phase(n, title):
    print(f"== phase {n}: {title}", flush=True)
    return time.perf_counter()


def done(n, t0):
    print(f"phase {n} seconds: {time.perf_counter() - t0:.3f}", flush=True)


def bound(nbytes, flops):
    """(ms, 'bytes' | 'operations'): the least time the card could take to
    move nbytes and do flops float32 operations at its published peaks."""
    t_b, t_f = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def sparse_coo(shape, nnz, duplicates, long_row, seed=4):
    """Coordinates at even indices only (so every mode has empty rows), the
    first `duplicates` repeated, and `long_row` extra nonzeros in row 0 of
    mode 0; normal values."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, (d + 1) // 2, nnz) * 2 for d in shape], 1)
    extra = np.stack([rng.integers(0, (d + 1) // 2, long_row) * 2
                      for d in shape], 1)
    extra[:, 0] = 0
    idx = np.concatenate([idx, idx[:duplicates], extra]).astype(np.int32)
    return idx, rng.standard_normal(len(idx)), rng


def fiber_gathers(plan):
    """Factor rows the fiber kernel gathers from L2 for a plan, a column
    tile: one at every nonzero whose fiber coordinate differs from the
    previous nonzero its group walked.  Group g walks nonzeros gQ .. gQ+Q-1
    of each 32 of a chunk, so that one is Q - 33 back at a quad's start."""
    import torch
    from matlab_code_tpu_torch.ops.sparse_cuda import fiber_lanes
    Q = fiber_lanes(plan.lanes, plan.vals.element_size())
    cs = plan.chunk_start
    chunk_of = torch.repeat_interleave(
        torch.arange(plan.nchunks, device=cs.device), cs[1:] - cs[:-1])
    e = torch.arange(plan.vals.shape[0], device=cs.device)
    pos = e - cs[:-1][chunk_of]
    first = (pos < 32) & (pos % Q == 0)   # a group's first in the chunk
    prev = torch.where(pos % Q > 0, e - 1, e - (33 - Q)).clamp(min=0)
    j = plan.coords[:, 0]
    return int((first | (j != j[prev])).sum())


def sparse_times(plan, chunk_plan, f32, idx, val32, shape, mode, R, flush,
                 power):
    """Times at full size: the fiber kernel and the chunk kernel, in turns
    (fiber, chunk, chunk, fiber), the chunk kernel on the fiber plan's
    order, and the plain version; prints rates beside the bound."""
    from matlab_code_tpu_torch.ops.sparse_cuda import (
        fiber_blocks, lanes_for, mttkrp_sparse_cuda, mttkrp_sparse_reference)
    import torch
    nnz = idx.shape[0]
    on_fiber_order = plan._replace(variant="chunk", lanes=lanes_for(R))
    runs = [time_ms(lambda: mttkrp_sparse_cuda(p, f32), flush)
            for p in (plan, chunk_plan, chunk_plan, plan)]
    t_f, t_c = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    t_cf = time_ms(lambda: mttkrp_sparse_cuda(on_fiber_order, f32), flush)
    t_p = time_ms(lambda: mttkrp_sparse_reference(
        idx, val32, f32, mode, shape[mode]), flush, runs=10)
    # the plan (coords, values, chunk tables), the gathered factors and
    # the output, once each; 3R flops a nonzero
    stream = nnz * (2 * 4 + 4)
    nbytes = (stream + 8 * (plan.chunk_start.numel() + plan.chunk_ptr.numel())
              + 4 * R * sum(shape))
    t_b, bound_by = bound(nbytes, 3 * nnz * R)
    passes = -(-R // plan.lanes)
    gathers = fiber_gathers(plan)
    res = plan.gather_modes[1]
    fill = (fiber_blocks(plan.nchunks, torch.cuda.get_device_properties(
        0).multi_processor_count) * shape[res] * 4 * R)
    l2 = gathers * 4 * R + fill
    print(f"  time, mode {mode}: fiber kernel {t_f * 1e3:.1f} us ({runs[0] * 1e3:.1f}"
          f", {runs[3] * 1e3:.1f}; P {plan.lanes}, {passes} pass(es) over the "
          f"stream at {passes * stream / 1e6 / t_f:.0f} GB/s; {gathers} fiber "
          f"rows = {gathers / nnz:.3f} a nonzero, with the tile fill "
          f"{l2 / 1e6:.1f} MB from L2 at {l2 / 1e6 / t_f:.0f} GB/s; "
          f"{t_b / t_f:.1%} of the {t_b * 1e3:.1f} us bound, {bound_by})")
    print(f"    chunk kernel {t_c * 1e3:.1f} us ({runs[1] * 1e3:.1f}, "
          f"{runs[2] * 1e3:.1f}; stream {stream / 1e6 / t_c:.0f} GB/s, gathered"
          f" rows {8 * R * nnz / 1e6 / t_c:.0f} GB/s); chunk kernel on the "
          f"fiber-sorted plan {t_cf * 1e3:.1f} us; fiber kernel "
          f"{t_c / t_f:.2f}x the chunk kernel | plain {t_p * 1e3:.1f} us  "
          f"[{power}]")
    return {"kernel": t_f, "chunk": t_c, "plain": t_p, "bound": t_b,
            "bound_by": bound_by}


def sparse_phases(dev, power):
    """Phases 6-8: the sparse COO path.  Returns the sparse kernel's entry
    of the kernels line."""
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops.sparse_cuda import (
        CHUNK, build_plan, mttkrp_sparse_cuda, mttkrp_sparse_reference)
    from matlab_code_tpu_torch.utils import sparse_workload as sw

    # ---- 6. sparse kernels vs plain -----------------------------------------
    t0 = phase(6, "sparse MTTKRP kernels vs plain")
    tb = time.perf_counter()
    spec, data = sw.build_problem(device=dev, dtype=torch.float32)
    st = data.objects[0]
    torch.cuda.synchronize()
    print(f"sparse workload: {st.indices.shape[0]} nonzeros of "
          f"{spec.mode_sizes}, R {sw.R}, built on the card in "
          f"{time.perf_counter() - tb:.2f} s")
    tb = time.perf_counter()
    st = st.with_plans(spec.mode_sizes, sw.R)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - tb
    print(f"plans of the three modes built on the card in {plan_s:.3f} s "
          f"({[p.nchunks for p in st.plans]} chunks of <= {CHUNK} nonzeros; "
          f"kernels {[(p.variant, p.lanes, p.gather_modes) for p in st.plans]}"
          f" as (variant, P, gathered modes))")
    data.objects = (st,)
    rng = np.random.default_rng(1)
    full = (spec.mode_sizes, st.indices, st.values, sw.R)
    cases = [full] + [
        (shape, torch.tensor(idx, device=dev),
         torch.tensor(val, device=dev, dtype=torch.float32), R)
        for shape, nnz, R, dup, long_row in SPARSE_RAGGED
        for idx, val, _ in [sparse_coo(shape, nnz, dup, long_row)]]
    flush = l2_flush(dev)
    max_abs_err = ms = plain_ms = bound_ms = chunk_ms = 0.0
    bound_by_ms = {"bytes": 0.0, "operations": 0.0}
    for n_case, (shape, idx, val32, R) in enumerate(cases):
        facs = [rng.standard_normal((d, R)) for d in shape]
        f32 = [torch.tensor(f, dtype=torch.float32, device=dev) for f in facs]
        f64 = [f.double() for f in f32]
        val64 = val32.double()
        nnz = idx.shape[0]
        for mode in range(3):
            want = mttkrp_sparse_reference(idx, val64, f64, mode, shape[mode])
            scale = want.abs().max().item()
            p32 = st.plans[mode] if n_case == 0 else build_plan(
                idx, val32, shape, mode, R)
            c32 = build_plan(idx, val32, shape, mode, R, variant="chunk")
            held = [p32] + ([c32] if p32.variant != "chunk" else [])
            for q32 in held:
                q64 = build_plan(idx, val64, shape, mode, R, variant=q32.variant)
                got = mttkrp_sparse_cuda(q32, f32)
                got64 = mttkrp_sparse_cuda(q64, f64)
                torch.cuda.synchronize()
                err = (got.double() - want).abs().max().item()
                err64 = (got64 - want).abs().max().item()
                same = bool(torch.equal(mttkrp_sparse_cuda(q32, f32), got)
                            and torch.equal(mttkrp_sparse_cuda(q64, f64), got64))
                print(f"{shape} nnz={nnz} R={R} mode {mode}, {q32.variant} "
                      f"kernel (P {q32.lanes} float32, {q64.lanes} float64): "
                      f"max|kernel-plain_f64| = {err:.3e} (bound "
                      f"{1e-4 * scale:.3e}); float64 kernel {err64:.3e} (bound "
                      f"{1e-12 * scale:.3e}); same bits on repeat: {same}")
                if not err <= 1e-4 * scale:
                    raise RuntimeError(f"{q32.variant} sparse kernel disagrees: "
                                       f"{shape} mode {mode}")
                if not err64 <= 1e-12 * scale:
                    raise RuntimeError(f"float64 {q32.variant} sparse kernel "
                                       f"disagrees: {shape} mode {mode}")
                if not same:
                    raise RuntimeError(f"{q32.variant} sparse kernel not "
                                       f"deterministic: {shape} mode {mode}")
                max_abs_err = max(max_abs_err, err)
                del q64, got64
            del want
            if n_case == 0:
                t = sparse_times(p32, c32, f32, idx, val32, shape, mode, R,
                                 flush, power)
                ms += t["kernel"]
                chunk_ms += t["chunk"]
                plain_ms += t["plain"]
                bound_ms += t["bound"]
                bound_by_ms[t["bound_by"]] += t["bound"]
            del c32
        del f32, f64, val64
    print(f"three sparse MTTKRPs (one sweep) at full size: fiber kernel "
          f"{ms:.3f} ms, chunk kernel {chunk_ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.3f} ms")
    # which roof sets the pace: other ranks read the same 12 B/nnz stream
    # (once a column tile) but gather 4R bytes a factor row
    nnz = st.indices.shape[0]
    for R in (8, 32):
        fr = [torch.rand((d, R), device=dev) for d in spec.mode_sizes]
        for variant in ("fiber", "chunk"):
            pr = build_plan(st.indices, st.values, spec.mode_sizes, 0, R,
                            variant=variant)
            t_k = time_ms(lambda: mttkrp_sparse_cuda(pr, fr), flush)
            print(f"  rank probe, full size, mode 0, R {R}: {variant} kernel "
                  f"(P {pr.lanes}) {t_k * 1e3:.1f} us (stream {12 * nnz / 1e6 / t_k:.0f}"
                  f" GB/s a pass)  [{power}]")
            del pr
    del flush, cases, fr
    done(6, t0)

    # ---- 7. the sparse fit on the card ---------------------------------------
    t0 = phase(7, f"sparse CP fit, {SPARSE_ITERS} outer iterations, float32")
    opts = sw.sparse_options(SPARSE_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    mttkrp_sparse_cuda.launches = 0
    to_host.calls = 0
    zhat, state, state0, out = cmtf_aoadmm(
        spec, data, opts, init_options=sw.sparse_init_options(), generator=gen)
    launches = mttkrp_sparse_cuda.launches
    syncs = to_host.calls
    streams = np.stack([out.func_val_conv, out.func_coupl_conv,
                        out.func_constr_conv, out.func_PAR2_coupl])
    if out.OuterIterations != SPARSE_ITERS or \
            streams.shape != (4, SPARSE_ITERS + 1):
        raise RuntimeError(f"sparse fit ran {out.OuterIterations} iterations")
    if not np.all(np.isfinite(streams)):
        raise RuntimeError("non-finite objective stream in the sparse fit")
    if not out.func_val_conv[-1] < out.func_val_conv[0]:
        raise RuntimeError("f_tensors did not decrease in the sparse fit")
    if launches < 3 * SPARSE_ITERS + 1:
        raise RuntimeError(f"only {launches} sparse kernel launches")
    if [f.shape for f in zhat[0]["factors"]] != [(sw.D, sw.R)] * 3:
        raise RuntimeError("unexpected factor shapes in the sparse fit")
    dts = np.diff(out.time_at_it)
    print(f"f_tensors {out.func_val_conv[0]:.6e} -> {out.f_tensors:.6e}; "
          f"f_constraints {out.f_constraints:.3e}; exit {out.exit_flag}")
    print(f"sparse kernel launches {launches} ({launches / SPARSE_ITERS:.2f} per "
          f"outer iteration); host syncs {syncs} ({syncs / SPARSE_ITERS:.2f} per "
          f"outer iteration)")
    print(f"iterations/s {SPARSE_ITERS / out.time_total:.2f}; median ms per "
          f"outer iteration {np.median(dts) * 1e3:.3f} (min {dts.min() * 1e3:.3f}"
          f", max {dts.max() * 1e3:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; plan build "
          f"{plan_s:.3f} s  [{power}]")
    init_np = state_to_numpy(state0)
    del zhat, state
    done(7, t0)

    # ---- 8. card vs CPU on the sparse path -------------------------------------
    t0 = phase(8, f"sparse: card (float32) vs CPU (float64), "
                  f"{SPARSE_CPU_ITERS} iterations, full size")
    opts3 = sw.sparse_options(SPARSE_CPU_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_gpu = fit(spec, data, state_from_numpy(init_np, dev, torch.float32),
                     opts3)
    tc = time.perf_counter()
    _, data_c = sw.build_problem(device="cpu", dtype=torch.float64)
    _, out_cpu = fit(spec, data_c, state_from_numpy(init_np, "cpu",
                                                    torch.float64), opts3)
    print(f"CPU side ({data_c.objects[0].indices.shape[0]} nonzeros, float64): "
          f"{time.perf_counter() - tc:.1f} s")
    for label, a, b in [
            ("f_tensors", out_gpu.func_val_conv, out_cpu.func_val_conv),
            ("f_constraints", out_gpu.func_constr_conv, out_cpu.func_constr_conv)]:
        rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))
        print(f"{label}: card {a[-1]:.9e} cpu {b[-1]:.9e} max rel diff {rel:.3e}")
        np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=label)
    done(8, t0)

    return {"name": "mttkrp_sparse", "route": "cuda", "source": SPARSE_SOURCE,
            "replaces": SPARSE_REPLACES, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": max(bound_by_ms, key=bound_by_ms.get),
            "library_ms": None}


def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi clocks.max.sm: {proc.stderr.strip()}")
    return float(proc.stdout.strip().splitlines()[0]) * 1e6


def prox_inputs(n, R, seed):
    """A normal (n, R) matrix with a constant column, a column of ties (a
    0.5 grid), an all-negative column and a column with a long plateau."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, R))
    if R >= 4:
        X[:, 1] = 0.3
        X[:, 2] = np.round(2 * X[:, 2]) / 2
        X[:, 3] = -np.abs(X[:, 3]) - 0.1
    if R >= 5:
        X[n // 4: 3 * n // 4, 4] = 1.0
    return X


def check_close(got, want, rtol, label):
    """max |got - want| / |want| elementwise (0 where both are 0); raises
    past rtol.  Returns the largest absolute difference."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    diff = (g - w).abs()
    rel = torch.where(diff == 0, torch.zeros_like(diff),
                      diff / w.abs().clamp(min=1e-300))
    if not bool((rel <= rtol).all()):
        raise RuntimeError(f"{label}: max rel diff {float(rel.max()):.3e} > "
                           f"{rtol:.0e}")
    return float(diff.max())


def profile_fit(spec, data, state, opts, top=8, run=None):
    """Run fit (or run(), where given) under torch.profiler and print the
    device time by kernel (top `top`) and the device's busy share of the
    wall clock (both under the profiler's own overhead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from matlab_code_tpu_torch.models.solver import fit
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if run is None:
            fit(spec, data, state, opts)
        else:
            run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print("  profiler: no device time recorded (not measured)")
        return
    print(f"  profiler, {opts.MaxOuterIters} outer iterations: device busy "
          f"{busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall ({busy / wall_us:.1%}); "
          f"{sum(r[1] for r in rows)} device calls; top by device time:")
    for t_us, count, key in rows[:top]:
        print(f"    {t_us / 1e3:8.3f} ms  {count:6d} calls  {key[:90]}")


def prox_phases(dev, power):
    """Phases 9 and 10: the sequential-prox kernels and the CP surface.
    Returns the kernels line's entries of kernels A and B."""
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops import isotonic, prox, prox_cuda, tv
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.prox_cuda import (
        project_isotonic_cols, prox_tv_cols)
    from matlab_code_tpu_torch.utils import surface

    # ---- 9. sequential-prox kernels vs plain ----------------------------------
    t0 = phase(9, "sequential-prox kernels (A: isotonic/unimodal, B: TV) vs plain")
    kinds_a = ((isotonic.INCREASING, False, "non-decreasing"),
               (isotonic.DECREASING, False, "non-increasing"),
               (isotonic.UNIMODAL, False, "unimodal"),
               (isotonic.UNIMODAL, True, "unimodal, non-negative"))
    err_a = err_b = 0.0
    checked = 0
    routes = {}      # (kernel, route) -> the (n, R) cases that took it
    cases = [(n, R, n, R) for n in PROX_NS for R in PROX_RS]
    cases += [(*PROX_LONG_A, 0, 0), (0, 0, *PROX_LONG_B)]
    for n_a, R_a, n_b, R_b in cases:
        for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            if n_a:
                X = prox_inputs(n_a, R_a, 7 * n_a + R_a)
                Xd = torch.tensor(X, dtype=dt, device=dev)
                Xh = Xd.double().cpu()      # the plain version's float64 input
                route = prox_cuda.plan_isotonic(n_a, R_a, dt)[0]
                routes.setdefault(("A", route), set()).add((n_a, R_a))
                for kind, nn, label in kinds_a:
                    case = f"kernel A {label} {n_a}x{R_a} {dt} ({route} route)"
                    want = isotonic.columns_reference(Xh, kind, nn)
                    before = project_isotonic_cols.route_launches[route]
                    got = project_isotonic_cols(Xd, kind, nn)
                    again = project_isotonic_cols(Xd, kind, nn)
                    torch.cuda.synchronize()
                    if got.dtype != dt or not torch.equal(got, again) or \
                            project_isotonic_cols.route_launches[route] != before + 2:
                        raise RuntimeError(f"{case}: dtype {got.dtype}, same bits "
                                           f"{torch.equal(got, again)}, launches "
                                           f"{project_isotonic_cols.route_launches}")
                    e = check_close(got, want, rtol, case)
                    if dt == torch.float32:
                        err_a = max(err_a, e)
                    if nn and float(got.min()) < 0:
                        raise RuntimeError(f"{case}: negative non-negative unimodal")
            if n_b:
                X = prox_inputs(n_b, R_b, 7 * n_b + R_b)
                tv_max = float(np.max(np.sum(np.abs(np.diff(X, axis=0)), axis=0))) \
                    if n_b > 1 else 0.0
                Xd = torch.tensor(X, dtype=dt, device=dev)
                Xh = Xd.double().cpu()
                route = prox_cuda.plan_tv(n_b, R_b, dt)[0]
                routes.setdefault(("B", route), set()).add((n_b, R_b))
                for lam in (0.0, 0.05, tv_max + 1.0):
                    case = f"kernel B {n_b}x{R_b} {dt} lam {lam} ({route} route)"
                    want = tv.columns_reference(Xh, lam)
                    lam_d = torch.tensor(lam, dtype=torch.float64, device=dev)
                    before = prox_tv_cols.route_launches[route]
                    got = prox_tv_cols(Xd, lam_d)
                    again = prox_tv_cols(Xd, lam)
                    torch.cuda.synchronize()
                    if got.dtype != dt or not torch.equal(got, again) or \
                            prox_tv_cols.route_launches[route] != before + 2:
                        raise RuntimeError(f"{case}: same bits "
                                           f"{torch.equal(got, again)}, launches "
                                           f"{prox_tv_cols.route_launches}")
                    e = check_close(got, want, rtol, case)
                    if dt == torch.float32:
                        err_b = max(err_b, e)
            checked += 1
    for (name, route), shapes in sorted(routes.items()):
        print(f"  kernel {name}, {route} route: {len(shapes)} (n, R) cases, n "
              f"{sorted({n for n, _ in shapes})}")
    if {k for k in routes} != {("A", "shared"), ("A", "global"),
                                ("B", "shared"), ("B", "global")}:
        raise RuntimeError(f"phase 9 did not check every route: {sorted(routes)}")
    print(f"kernels A and B held to the float64 plain version at {checked} "
          f"(n, R, dtype) cases x 4 kinds / 3 lam (float64 rtol 1e-12, float32 "
          f"rtol 1e-5 elementwise; same bits on repeat); float32 max abs diff "
          f"A {err_a:.3e}, B {err_b:.3e}")
    clock = sm_clock_hz()
    flush = l2_flush(dev)
    timed = {}
    for n, R in PROX_TIMED:
        X = torch.tensor(prox_inputs(n, R, 3), dtype=torch.float32, device=dev)
        Xh = X.double().cpu()
        lam_d = torch.tensor(1e-3, dtype=torch.float64, device=dev)
        for name in ("A", "B"):
            steps = []
            tc = time.perf_counter()
            if name == "A":
                isotonic.columns_reference(Xh, isotonic.UNIMODAL, True, steps)
                route = prox_cuda.plan_isotonic(n, R, X.dtype)[0]
                fn = functools.partial(project_isotonic_cols, X,
                                       isotonic.UNIMODAL, True)
                glob = functools.partial(prox_cuda._isotonic, X,
                                         isotonic.UNIMODAL, True, prox_cuda.GLOBAL)
            else:
                tv.columns_reference(Xh, 1e-3, steps)
                route = prox_cuda.plan_tv(n, R, X.dtype)[0]
                fn = functools.partial(prox_tv_cols, X, lam_d)
                glob = functools.partial(prox_cuda._tv, X, lam_d, prox_cuda.GLOBAL)
            t_plain = (time.perf_counter() - tc) * 1e3
            if route != "shared" or not torch.equal(fn(), glob()):
                raise RuntimeError(f"kernel {name} {n}x{R}: route {route}, or "
                                   "the two routes' bits differ")
            # the two routes in turns: global, shared, shared, global
            t_g1 = time_ms(glob, flush)
            t_s1 = time_ms(fn, flush)
            t_s2 = time_ms(fn, flush)
            t_g2 = time_ms(glob, flush)
            t_k, t_g = (t_s1 + t_s2) / 2, (t_g1 + t_g2) / 2
            t_bytes = 2 * X.numel() * 4 / HBM_BYTES_S * 1e3
            # each output row depends on the rows before it: n dependent
            # steps, one a clock; the plain walk's longest chain (a scan's
            # slots and merges, or Condat's states) is printed beside it
            chain = n
            t_steps = chain / clock * 1e3
            t_b = max(t_bytes, t_steps)
            timed[(name, n, R)] = (t_k, t_plain, t_b,
                                   "operations" if t_steps >= t_bytes else "bytes",
                                   t_g)
            print(f"  kernel {name} ({'unimodal, non-negative' if name == 'A' else 'TV, lam 1e-3'}"
                  f") {n}x{R} float32: shared route {t_k * 1e3:.1f} us ({t_s1 * 1e3:.1f}, "
                  f"{t_s2 * 1e3:.1f}) | global route {t_g * 1e3:.1f} us ({t_g1 * 1e3:.1f}, "
                  f"{t_g2 * 1e3:.1f}): {t_g / t_k:.2f}x | bound "
                  f"{t_b * 1e3:.3f} us ({chain} dependent steps at "
                  f"{clock / 1e9:.2f} GHz: {t_steps * 1e3:.3f} us; bytes "
                  f"{t_bytes * 1e3:.3f} us) = {t_b / t_k:.2%} of the shared route; "
                  f"the plain walk's longest chain {max(steps)} steps | plain (CPU, "
                  f"host clock) {t_plain:.1f} ms  [{power}]")
    del flush
    # every other new prox kind on a card tensor, against the CPU in float64
    X = prox_inputs(4096, 20, 5)
    rng = np.random.default_rng(9)
    M = rng.standard_normal((4096, 8))
    quad = np.diag(np.full(4096, 2.0)) + 0.01 * (M @ M.T) / 8
    others = [("simplex column-wise", (1.0,)), ("simplex row-wise", (1.0,)),
              ("l1-ball", (2.0,)), ("l2-ball", (1.0,)),
              ("non-negative l2-ball", (1.0,)), ("orthonormal", ()),
              ("l1 regularization", (0.1,)), ("l0 regularization", (0.05,)),
              ("l2 regularization", (0.3,)), ("ridge", (0.2,)),
              ("quadratic regularization", (0.5,)), ("GL smoothness", (1.0,))]
    worst = 0.0
    for kind, params in others:
        spec = prox.ConstraintSpec(kind, params,
                                   quad if kind == "quadratic regularization"
                                   else None)
        pf, rf = prox.make_prox(spec, 4096)
        rho = 0.7
        got = pf(torch.tensor(X, device=dev),
                 torch.tensor(rho, dtype=torch.float64, device=dev))
        want = pf(torch.tensor(X), rho)
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if got.device.type != torch.device(dev).type or not err <= 1e-10 * scale:
            raise RuntimeError(f"prox {kind}: card vs CPU {err:.3e} (scale "
                               f"{scale:.3e})")
        if rf is not None:
            a, b = float(rf(torch.tensor(X, device=dev))), float(rf(torch.tensor(X)))
            if not abs(a - b) <= 1e-10 * abs(b):
                raise RuntimeError(f"reg {kind}: card {a} vs CPU {b}")
    print(f"{len(others)} other prox kinds on a 4096x20 card tensor (float64) "
          f"against the CPU: max |card - CPU| / max|CPU| = {worst:.3e} (bound "
          f"1e-10: other summation orders and factorizations)")
    done(9, t0)

    # ---- 10. the CP surface at full size --------------------------------------
    t0 = phase(10, f"CP surface, coupling types {surface.CTYPES}, "
                   f"{SURFACE_ITERS} outer iterations, float32")
    launches = {"A": 0, "B": 0}
    route_launches = {"A": dict.fromkeys(project_isotonic_cols.route_launches, 0),
                      "B": dict.fromkeys(prox_tv_cols.route_launches, 0)}
    for ctype in surface.CTYPES:
        tc = time.perf_counter()
        spec, data, ds = surface.build_problem(ctype, dev, torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctype)
        state0 = init_coupled(spec, data, surface.surface_init_options(ctype),
                              generator=gen, delta_shapes=ds)
        opts = surface.surface_options(SURFACE_ITERS, AbsFuncTol=0.0,
                                       OuterRelTol=0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mttkrp3.launches = project_isotonic_cols.launches = 0
        prox_tv_cols.launches = to_host.calls = 0
        for fn in (project_isotonic_cols, prox_tv_cols):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        zhat, _, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
        n_mk, n_a, n_b = (mttkrp3.launches, project_isotonic_cols.launches,
                          prox_tv_cols.launches)
        routes_a = dict(project_isotonic_cols.route_launches)
        routes_b = dict(prox_tv_cols.route_launches)
        syncs = to_host.calls
        launches["A"] += n_a
        launches["B"] += n_b
        for name, r in (("A", routes_a), ("B", routes_b)):
            for k, v in r.items():
                route_launches[name][k] += v
        if routes_a["shared"] != n_a or routes_b["shared"] != n_b:
            raise RuntimeError(f"surface type {ctype}: kernel A routes {routes_a}, "
                               f"kernel B routes {routes_b}")
        streams = np.stack([out.func_val_conv, out.func_coupl_conv,
                            out.func_constr_conv, out.func_PAR2_coupl])
        if out.OuterIterations != SURFACE_ITERS or not np.all(np.isfinite(streams)):
            raise RuntimeError(f"surface type {ctype}: {out.OuterIterations} "
                               "iterations or non-finite streams")
        if n_mk < 6 * SURFACE_ITERS or n_a < SURFACE_ITERS or n_b < SURFACE_ITERS:
            raise RuntimeError(f"surface type {ctype}: launches mttkrp3 {n_mk}, "
                               f"A {n_a}, B {n_b}")
        if [f.shape for f in zhat[0]["factors"]] != [
                (spec.mode_sizes[m], 16) for m in (0, 1, 2)]:
            raise RuntimeError("surface: unexpected factor shapes")
        dts = np.diff(out.time_at_it)
        print(f"type {ctype}: datasets {[tuple(X.shape) for X in data.objects]}"
              f", ranks {surface.RANKS[ctype]}; f_tensors {out.func_val_conv[0]:.6e}"
              f" -> {out.f_tensors:.6e}; f_couplings {out.f_couplings:.3e}; "
              f"f_constraints {out.f_constraints:.3e}")
        print(f"  median ms per outer iteration {np.median(dts) * 1e3:.3f} (min "
              f"{dts.min() * 1e3:.3f}, max {dts.max() * 1e3:.3f}); launches per "
              f"outer iteration: mttkrp3 {n_mk / SURFACE_ITERS:.2f}, kernel A "
              f"{n_a / SURFACE_ITERS:.2f} (routes {routes_a}), kernel B "
              f"{n_b / SURFACE_ITERS:.2f} (routes {routes_b}); "
              f"host syncs {syncs / SURFACE_ITERS:.2f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  [{power}]")
        opts3 = surface.surface_options(SURFACE_CPU_ITERS, AbsFuncTol=0.0,
                                        OuterRelTol=0.0)
        profile_fit(spec, data, state0, opts3)
        # the first iterations from one init state: card and CPU in float64
        init_np = state_to_numpy(state0)
        del data, zhat
        _, data64, _ = surface.build_problem(ctype, dev, torch.float64)
        _, out_gpu = fit(spec, data64, state_from_numpy(init_np, dev,
                                                         torch.float64), opts3)
        del data64
        tcpu = time.perf_counter()
        _, data_c, _ = surface.build_problem(ctype, "cpu", torch.float64)
        _, out_cpu = fit(spec, data_c, state_from_numpy(init_np, "cpu",
                                                         torch.float64), opts3)
        del data_c
        k = SURFACE_CPU_ITERS + 1
        for label, a, b, f32 in [
                ("f_tensors", out_gpu.func_val_conv, out_cpu.func_val_conv,
                 out.func_val_conv),
                ("f_couplings", out_gpu.func_coupl_conv, out_cpu.func_coupl_conv,
                 out.func_coupl_conv),
                ("f_constraints", out_gpu.func_constr_conv,
                 out_cpu.func_constr_conv, out.func_constr_conv),
                ("f_PAR2_couplings", out_gpu.func_PAR2_coupl,
                 out_cpu.func_PAR2_coupl, out.func_PAR2_coupl)]:
            den = np.maximum(np.abs(b), 1e-300)
            rel = np.max(np.abs(a - b) / den)
            rel32 = np.max(np.abs(f32[:k] - b) / den)
            print(f"  {label}: card float64 {a[-1]:.12e} cpu float64 "
                  f"{b[-1]:.12e} max rel diff {rel:.3e} (bound 1e-8); card "
                  f"float32 max rel diff {rel32:.3e} (not gated)")
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=0, err_msg=label)
        print(f"  type {ctype}: {time.perf_counter() - tc:.1f} s, the CPU "
              f"side {time.perf_counter() - tcpu:.1f} s")
    done(10, t0)

    entries = []
    for name, fn, main, replaces in (
            ("A", "project_isotonic_cols", (512, 16), ISOTONIC_REPLACES),
            ("B", "prox_tv_cols", (256, 16), TV_REPLACES)):
        t_k, t_p, t_b, by, t_g = timed[(name, *main)]
        entries.append({
            "name": fn, "route": "cuda", "source": PROX_SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err_a if name == "A" else err_b, "ms": t_k,
            "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
            "library_ms": None,
            # the kernel's own routes: their launches on the surface, and
            # the global route's time at the same shape ("ms" is the shared's)
            "kernel_routes": route_launches[name], "global_route_ms": t_g})
    return entries


def slice_stack(K, n, R, seed):
    """A (K, n, R) stack of float32-representable normal values, slice 0
    holding prox_inputs' special columns (constant, ties, all-negative, a
    plateau)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, n, R))
    X[0] = prox_inputs(n, R, seed)
    return X.astype(np.float32).astype(np.float64)


C_WIDE_ETAS = (1e-3, 1.0, 1e6)   # kernel C's bit check on wide operands
RAG_PLAIN_CALLS = 3   # phase 11: warm calls of kernel A's ragged plain version


def t_smooth_operands(X, rho, dt, dev, wide, seed):
    """Kernel C's (B, rho) on the card in dt: X and rho as they are, or wide
    ones of X's shape: B across 2^-60..2^60 with zeros, negative zeros and
    subnormals, rho in [1e-6, 1e6] (log-uniform)."""
    import torch
    if not wide:
        return (torch.tensor(X, dtype=dt, device=dev),
                torch.tensor(rho, dtype=dt, device=dev))
    npdt = np.float64 if dt == torch.float64 else np.float32
    rng = np.random.default_rng(seed)
    B = (rng.standard_normal(X.shape)
         * 2.0 ** rng.integers(-60, 61, X.shape)).astype(npdt)
    u = rng.random(X.shape)
    B[u < 0.05] = 0.0
    B[(u >= 0.05) & (u < 0.08)] = -0.0
    sub = (u >= 0.08) & (u < 0.11)
    B[sub] = (np.finfo(npdt).smallest_subnormal
              * rng.integers(1, 1000, int(sub.sum()))).astype(npdt)
    r = (10.0 ** rng.uniform(-6.0, 6.0, X.shape[0])).astype(npdt)
    return torch.tensor(B, device=dev), torch.tensor(r, device=dev)


def same_bits(a, b):
    """a and b hold the same bits (a negative zero is not a zero)."""
    import torch
    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.cpu().view(iv), b.cpu().view(iv))


def t_smooth_times(prox_cuda, X, rho, eta, flush, power):
    """Kernel C at X's shape in float32 and float64: the planned route
    (t_smooth_cols) and the other one in turns (other, planned, planned,
    other), and the recurrence warps alone on the staged route's grid (the
    bit-exact floor: K dependent steps of an IEEE division, a multiply and
    a subtract), ms."""
    import torch
    from matlab_code_tpu_torch.ops.mttkrp_cuda import _sms
    from matlab_code_tpu_torch.utils.time_prox_seq import phase_stamps
    K = X.shape[0]
    out = {}
    for dt in (torch.float32, torch.float64):
        Xd, rd = X.to(dt), rho.to(dt)
        planned = prox_cuda.plan_t_smooth(K, Xd[0].numel(), dt,
                                          _sms(Xd.device))[0]
        other = (prox_cuda.STREAM if planned == prox_cuda.STAGED
                 else prox_cuda.STAGED)
        kernel = functools.partial(prox_cuda.t_smooth_cols, Xd, rd, eta)
        alt = functools.partial(prox_cuda._t_smooth, Xd, rd, eta, other)
        t_a1 = time_ms(alt, flush)
        t_k = (time_ms(kernel, flush) + time_ms(kernel, flush)) / 2
        t_a = (t_a1 + time_ms(alt, flush)) / 2
        dbg = torch.zeros(4 * K, dtype=dt, device=Xd.device)
        floor = time_ms(functools.partial(
            prox_cuda._t_smooth_phase, prox_cuda.PHASE_RECURRENCE, Xd, rd, eta,
            dbg, torch.empty_like(Xd)), flush)
        # one staged launch with the kernel's clock stamps: the SM clock the
        # card ran this kernel at (latency-bound, its time scales with it),
        # and the medians over blocks of its spans
        spans = phase_stamps(prox_cuda, prox_cuda.PHASE_ALL, Xd, rd, dbg,
                             torch.empty_like(Xd))
        name = str(dt).split(".")[-1]
        out[name] = {"route": planned, "ms": t_k, f"{planned}_ms": t_k,
                     f"{other}_ms": t_a, "floor_ms": floor,
                     "staged_stamps_us": spans}
        print(f"  kernel C {tuple(X.shape)} {name}: {planned} route (planned) "
              f"{t_k * 1e3:.1f} us, {other} route {t_a * 1e3:.1f} us (in "
              f"turns); the recurrence alone (the floor) {floor * 1e3:.1f} us, "
              f"{floor / t_k:.0%} of the planned route; the staged route's "
              f"stamps: SM clock {spans['clock_ghz']:.2f} GHz, recurrence "
              f"{spans['recurrence']:.2f} us, back substitution "
              f"{spans['back substitution']:.2f} us, first block start to "
              f"last end {spans['first start to last end']:.2f} us  [{power}]")
    return out


def fit_times(out):
    """(median, p90) ms of the outer iterations of a fit."""
    dts = np.diff(out.time_at_it) * 1e3
    return float(np.median(dts)), float(np.percentile(dts, 90))


def hold_streams(out_gpu, out_cpu, label):
    """The card's four float64 streams against the CPU's at rtol 1e-8."""
    for name, a, b in [
            ("f_tensors", out_gpu.func_val_conv, out_cpu.func_val_conv),
            ("f_couplings", out_gpu.func_coupl_conv, out_cpu.func_coupl_conv),
            ("f_constraints", out_gpu.func_constr_conv, out_cpu.func_constr_conv),
            ("f_PAR2_couplings", out_gpu.func_PAR2_coupl, out_cpu.func_PAR2_coupl)]:
        rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))
        print(f"  {label} {name}: card float64 {a[-1]:.12e} cpu float64 "
              f"{b[-1]:.12e} max rel diff {rel:.3e} (bound 1e-8)")
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=0,
                                   err_msg=f"{label} {name}")


def par2_phases(dev, power):
    """Phases 11-13: the slice-wise kernels, the PAR2 K=512 workload and
    the PARAFAC2 surface.  Returns the kernels line's additions: kernel C's
    entry, the batched measurements of kernels A and B, and mttkrp3's
    launches on the coupled configuration."""
    import dataclasses
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models import admm
    from matlab_code_tpu_torch.models.admm import (
        prox_slicewise_ragged, to_host)
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops import isotonic, prox, prox_cuda, tv
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.prox_cuda import (
        project_isotonic_cols, prox_tv_cols, t_smooth_cols)
    from matlab_code_tpu_torch.utils import par2_surface, par2_workload

    counters = {"A": project_isotonic_cols, "B": prox_tv_cols,
                "C": t_smooth_cols, "mttkrp3": mttkrp3}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        for fn in (project_isotonic_cols, prox_tv_cols, t_smooth_cols):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        to_host.calls = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    # ---- 11. slice-wise kernels vs plain -------------------------------------
    t0 = phase(11, "slice-wise kernels (A, B batched over slices; C: tPARAFAC2) "
                   "vs plain")
    kinds_a = ((isotonic.UNIMODAL, True), (isotonic.UNIMODAL, False),
               (isotonic.INCREASING, False), (isotonic.DECREASING, False))
    err = {"A": 0.0, "B": 0.0, "C": 0.0}
    plain_ms = {}
    checked = []
    lanes_checked = 0
    for shape in (PAR2_SHAPE, (1, 256, 32), (2, 29, 5), (3, 256, 32),
                  (7, 29, 5)):
        K, n, R = shape
        full = shape == PAR2_SHAPE
        X = slice_stack(K, n, R, K + n)
        Xh = torch.tensor(X)
        lam = np.linspace(0.0, 0.05, K)
        if K >= 3:
            lam[-1] = 1.0 + float(np.max(np.sum(np.abs(np.diff(X, axis=1)),
                                                axis=1)))
        for kind, nn in kinds_a[:1] if full else kinds_a:
            tc = time.perf_counter()
            want = isotonic.columns_reference(Xh, kind, nn)
            if full:
                plain_ms["A"] = (time.perf_counter() - tc) * 1e3
            for dt in (torch.float64, torch.float32):
                Xd = torch.tensor(X, dtype=dt, device=dev)
                before = project_isotonic_cols.launches
                got = project_isotonic_cols(Xd, kind, nn)
                lanes = prox_cuda._isotonic(Xd, kind, nn, prox_cuda.LANES)
                torch.cuda.synchronize()
                if project_isotonic_cols.launches != before + 2:
                    raise RuntimeError("kernel A: not one launch a stack")
                label = f"kernel A kind {kind} nonneg {nn} {shape} {dt}"
                # the lanes route: float64 the plain walk's bits, float32
                # those rounded once, as the planned route
                for route, res in (("planned", got), ("lanes", lanes)):
                    if not torch.equal(res.cpu(), want.to(dt)):
                        raise RuntimeError(f"{label} ({route}): not the plain "
                                           "walk's bits (rounded once)")
                lanes_checked += 1
                e = check_close(got, want, 1e-12 if dt == torch.float64
                                else 1e-5, label)
                if dt == torch.float32:
                    err["A"] = max(err["A"], e)
        tc = time.perf_counter()
        want = tv.columns_reference(Xh, torch.tensor(lam))
        if full:
            plain_ms["B"] = (time.perf_counter() - tc) * 1e3
        for dt in (torch.float64, torch.float32):
            Xd = torch.tensor(X, dtype=dt, device=dev)
            before = prox_tv_cols.launches
            got = prox_tv_cols(Xd, torch.tensor(lam, device=dev))
            lanes = prox_cuda._tv(Xd, torch.tensor(lam, device=dev),
                                  prox_cuda.LANES)
            torch.cuda.synchronize()
            label = f"kernel B {shape} {dt}, one lam a slice"
            if prox_tv_cols.launches != before + 2 or not torch.equal(got[0], Xd[0]):
                raise RuntimeError(f"{label}: launches or the lam = 0 slice")
            for route, res in (("planned", got), ("lanes", lanes)):
                if not torch.equal(res.cpu(), want.to(dt)):
                    raise RuntimeError(f"{label} ({route}): not the plain "
                                       "walk's bits (rounded once)")
            lanes_checked += 1
            e = check_close(got, want, 1e-12 if dt == torch.float64 else 1e-5,
                            label)
            if dt == torch.float32:
                err["B"] = max(err["B"], e)
        rho = np.random.default_rng(K).uniform(0.2, 3.0, K)
        for dt in (torch.float64, torch.float32):
            for wide, etas in ((False, (1000.0,)), (True, C_WIDE_ETAS)):
                Bd, rd = t_smooth_operands(X, rho, dt, dev, wide, K + n)
                for eta in etas:
                    tc = time.perf_counter()
                    want = prox.t_smoothness_reference(Bd.cpu(), rd.cpu(), eta)
                    if full and dt == torch.float32 and not wide:
                        plain_ms["C"] = (time.perf_counter() - tc) * 1e3
                    got = t_smooth_cols(Bd, rd, eta)
                    routes = [prox_cuda._t_smooth(Bd, rd, eta, prox_cuda.STREAM)]
                    if prox_cuda.t_smooth_smem(prox_cuda.STAGED, K, dt) \
                            <= prox_cuda.SMEM_LIMIT:
                        routes.append(prox_cuda._t_smooth(Bd, rd, eta,
                                                          prox_cuda.STAGED))
                    torch.cuda.synchronize()
                    if not all(same_bits(r, want) for r in [got] + routes):
                        raise RuntimeError(
                            f"kernel C {shape} {dt} eta {eta} (wide operands "
                            f"{wide}): a route gives other bits than the plain "
                            "version")
                    if not wide:
                        err["C"] = max(err["C"],
                                       float((got.cpu() - want).abs().max()))
        checked.append(shape)
    # a ragged stack: one lanes launch a call, padded rows exactly zero, the
    # bits of the CPU's size buckets
    sizes = par2_surface.slice_sizes("ragged", 64)
    X = slice_stack(64, max(sizes), 32, 5)
    for k, J in enumerate(sizes):
        X[k, J:] = 0.0
    rho = torch.tensor(np.random.default_rng(6).uniform(0.5, 2.0, 64))
    for kind, params, fn in (("unimodality", (True,), project_isotonic_cols),
                             ("TV regularization", (1e-3,), prox_tv_cols)):
        pf, _ = prox.make_prox(prox.ConstraintSpec(kind, params), 256)
        before, lanes = fn.launches, fn.route_launches[prox_cuda.LANES]
        got = prox_slicewise_ragged(pf, torch.tensor(X, device=dev),
                                    rho.to(dev), sizes)
        if fn.launches != before + 1 or \
                fn.route_launches[prox_cuda.LANES] != lanes + 1:
            raise RuntimeError(f"{kind} ragged: {fn.launches - before} launches "
                               f"for {len(set(sizes))} sizes, not one lanes launch")
        want = prox_slicewise_ragged(pf, torch.tensor(X), rho, sizes)
        if not torch.equal(got.cpu(), want):
            raise RuntimeError(f"{kind} ragged: not the plain walk's bits")
        if any(bool(got[k, J:].any()) for k, J in enumerate(sizes)):
            raise RuntimeError(f"{kind} ragged: a padded row is not zero")
    print(f"kernels A, B and C (both routes) held to their plain versions on "
          f"stacks {checked} (A and B on their planned route and on the lanes "
          f"route, {lanes_checked} cases: float64 the same bits, float32 those "
          f"rounded once; C the same bits in both dtypes, on normal draws at eta "
          f"1000 and on wide ones at eta {C_WIDE_ETAS}: B across 2^+-60 with "
          f"zeros and subnormals, rho in [1e-6, 1e6]) and kernels A and B "
          f"on 64 ragged slices of {len(set(sizes))} sizes (one lanes launch "
          f"a call, padded rows zero, the bits of the CPU's size buckets); "
          f"float32 max abs diff A {err['A']:.3e}, B {err['B']:.3e}, C "
          f"{err['C']:.3e}")
    clock = sm_clock_hz()
    flush = l2_flush(dev)
    # kernel A on that ragged stack, through prox_slicewise_ragged as the
    # fit calls it, in float32, against its plain version: the CPU's size
    # buckets on the same float32 stack, warm (one call first), the median
    # of RAG_PLAIN_CALLS calls on the host clock
    pf, _ = prox.make_prox(prox.ConstraintSpec("unimodality", (True,)), 256)
    Xh, rho_h = torch.tensor(X, dtype=torch.float32), rho.float()
    plain_ts = []
    for _ in range(RAG_PLAIN_CALLS + 1):
        tc = time.perf_counter()
        prox_slicewise_ragged(pf, Xh, rho_h, sizes)
        plain_ts.append((time.perf_counter() - tc) * 1e3)
    rag_plain_ms = float(np.median(plain_ts[1:]))
    Xd, rho_d = Xh.to(dev), rho_h.to(dev)
    t_rag = time_ms(lambda: prox_slicewise_ragged(pf, Xd, rho_d, sizes), flush)
    print(f"  kernel A on the ragged stack {len(sizes)}x{min(sizes)}-"
          f"{max(sizes)}x32 ({len(set(sizes))} sizes) through "
          f"prox_slicewise_ragged, float32: {t_rag * 1e3:.1f} us (one lanes "
          f"launch) | bound {2 * Xd.numel() * 4 / HBM_BYTES_S * 1e6:.2f} us "
          f"(bytes) | plain (CPU, its size buckets, float32, warm, median "
          f"of {RAG_PLAIN_CALLS} calls, host clock) {rag_plain_ms:.1f} ms "
          f"({', '.join(f'{t:.1f}' for t in plain_ts[1:])})  [{power}]")
    del Xd
    K, n, R = PAR2_SHAPE
    X = torch.tensor(slice_stack(K, n, R, 1), dtype=torch.float32, device=dev)
    lam_d = torch.full((K,), 1e-3, dtype=torch.float64, device=dev)
    rho_d = torch.rand(K, generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev) + 0.5
    t_bytes = 2 * X.numel() * 4 / HBM_BYTES_S * 1e3
    timed = {}
    block_ms = {}
    for name, fn, chain in (
            ("A", lambda: project_isotonic_cols(X, isotonic.UNIMODAL, True), n),
            ("B", lambda: prox_tv_cols(X, lam_d), n),
            ("C", lambda: t_smooth_cols(X, rho_d, 1000.0), 2 * K)):
        if name == "C":
            c_times = t_smooth_times(prox_cuda, X, rho_d, 1000.0, flush, power)
            if c_times["float32"]["route"] != prox_cuda.STAGED:
                raise RuntimeError("kernel C: the PAR2 shape is not staged in "
                                   "float32")
            t_k = c_times["float32"]["ms"]
            t_stream = c_times["float32"]["stream_ms"]
        else:
            # the lanes route (planned) against the block route in turns:
            # lanes, block, block, lanes
            planned = (prox_cuda.plan_isotonic if name == "A"
                       else prox_cuda.plan_tv)(n, R, X.dtype, K)[0]
            block = (functools.partial(prox_cuda._isotonic, X,
                                       isotonic.UNIMODAL, True, prox_cuda.SHARED)
                     if name == "A" else
                     functools.partial(prox_cuda._tv, X, lam_d, prox_cuda.SHARED))
            if planned != prox_cuda.LANES or not torch.equal(fn(), block()):
                raise RuntimeError(f"kernel {name}: the PAR2 stack plans "
                                   f"{planned}, or the routes' bits differ")
            t_l1 = time_ms(fn, flush)
            t_b1, t_b2 = time_ms(block, flush), time_ms(block, flush)
            t_l2 = time_ms(fn, flush)
            t_k, block_ms[name] = (t_l1 + t_l2) / 2, (t_b1 + t_b2) / 2
            print(f"  kernel {name}, lanes route {t_k * 1e3:.1f} us ({t_l1 * 1e3:.1f},"
                  f" {t_l2 * 1e3:.1f}) | block route "
                  f"{block_ms[name] * 1e3:.1f} us ({t_b1 * 1e3:.1f}, "
                  f"{t_b2 * 1e3:.1f}): {block_ms[name] / t_k:.2f}x  [{power}]")
        t_steps = chain / clock * 1e3
        t_b = max(t_bytes, t_steps)
        by = "operations" if t_steps > t_bytes else "bytes"
        timed[name] = (t_k, t_b, by)
        print(f"  kernel {name} at {PAR2_SHAPE} float32: {t_k * 1e3:.1f} us | "
              f"bound {t_b * 1e3:.2f} us ({by}: bytes {t_bytes * 1e3:.2f} us, "
              f"{chain} dependent steps at {clock / 1e9:.2f} GHz "
              f"{t_steps * 1e3:.2f} us) = {t_b / t_k:.2%} | plain (CPU, host "
              f"clock) {plain_ms[name]:.1f} ms  [{power}]")
    # kernel C's library call: torch.linalg.solve of the dense K x K
    # tridiagonal matrix (ops/prox.py:209-213) on the (K, J R) right-hand
    # side rho_k B_k, both built before the timing
    eta = 1000.0
    M = (torch.diag(4.0 * eta + rho_d) - 2.0 * eta * (
        torch.diag(torch.ones(K - 1, device=dev), 1)
        + torch.diag(torch.ones(K - 1, device=dev), -1)))
    M[0, 0] -= 2.0 * eta
    M[K - 1, K - 1] -= 2.0 * eta
    rhs = (rho_d[:, None, None] * X).reshape(K, n * R)
    # the same function: float32 solves of a system of condition ~1e4
    # agree to ~1e-3 of the solution's scale (a check of the call, not of
    # the kernel, which phase 11 holds to its plain version's bits)
    got_c = t_smooth_cols(X, rho_d, eta)
    lib_c = float((torch.linalg.solve(M, rhs).reshape(K, n, R) - got_c).abs().max())
    if not lib_c <= 1e-2 * float(got_c.abs().max()):
        raise RuntimeError(f"torch.linalg.solve of kernel C's system: max abs "
                           f"diff {lib_c:.3e}")
    t_lib_c = time_ms(lambda: torch.linalg.solve(M, rhs), flush)
    print(f"  kernel C's library call, torch.linalg.solve of the dense "
          f"{K}x{K} system on ({K}, {n * R}): {t_lib_c * 1e3:.1f} us "
          f"(kernel {timed['C'][0] * 1e3:.1f} us, {t_lib_c / timed['C'][0]:.2f}x;"
          f" max abs diff {lib_c:.3e})  [{power}]")
    del flush, X
    done(11, t0)

    # ---- 12. the PAR2 K=512 workload -------------------------------------------
    t0 = phase(12, f"PAR2 K=512 workload, {PAR2_ITERS} outer iterations, float32")
    spec, data = par2_workload.build_problem(dev, torch.float32)
    print(f"slices {tuple(data.objects[0].slices.shape)} "
          f"({data.objects[0].slices.numel() * 4 / 1e6:.0f} MB); inner_solve "
          f"'auto' on CUDA -> {admm._resolve_inner_solve(par2_workload.par2_options(), torch.device(dev), True)}, "
          f"par2_polar 'auto' -> {admm._resolve_polar(par2_workload.par2_options(), torch.device(dev))}")
    opts = par2_workload.par2_options(PAR2_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    zhat, _, state0, out = cmtf_aoadmm(
        spec, data, opts, init_options=par2_workload.par2_init_options(),
        generator=gen)
    n_launch, syncs = counts(), to_host.calls
    streams = np.stack([out.func_val_conv, out.func_coupl_conv,
                        out.func_constr_conv, out.func_PAR2_coupl])
    if out.OuterIterations != PAR2_ITERS or not np.all(np.isfinite(streams)) \
            or not out.func_val_conv[-1] < out.func_val_conv[0]:
        raise RuntimeError(f"PAR2 workload: {out.OuterIterations} iterations, "
                           f"finite {np.all(np.isfinite(streams))}")
    if len(zhat[0]["Bk"]) != spec.par2_K(0) or zhat[0]["A"].shape != (256, 32):
        raise RuntimeError("PAR2 workload: unexpected factor shapes")
    med, p90 = fit_times(out)
    print(f"f_tensors {out.func_val_conv[0]:.6e} -> {out.f_tensors:.6e}; "
          f"f_constraints {out.f_constraints:.3e}; f_PAR2_couplings "
          f"{out.f_PAR2_couplings:.3e}")
    print(f"ms per outer iteration: median {med:.3f}, p90 {p90:.3f}; host syncs "
          f"{syncs / PAR2_ITERS:.2f} an iteration; launches {n_launch}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  "
          f"[{power}]")
    profile_fit(spec, data, state0,
                par2_workload.par2_options(3, AbsFuncTol=0.0, OuterRelTol=0.0))
    sweep = {}
    for polar in ("svd", "ns"):
        for solve in ("chol", "inverse", "newton"):
            o = par2_workload.par2_options(2, AbsFuncTol=0.0, OuterRelTol=0.0,
                                           par2_polar=polar, inner_solve=solve)
            _, out_s = fit(spec, data, state0, o)
            sweep[(polar, solve)] = float(np.diff(out_s.time_at_it)[1] * 1e3)
    best = min(sweep, key=sweep.get)
    auto = (admm._resolve_polar(opts, torch.device(dev)),
            admm._resolve_inner_solve(opts, torch.device(dev), True))
    print("one outer sweep (the second of a 2-iteration fit, ms) by par2_polar x "
          "inner_solve: " + ", ".join(f"{p}/{q} {t:.3f}" for (p, q), t in
                                      sweep.items())
          + f"; fastest {best[0]}/{best[1]}; 'auto' on CUDA is "
          f"{auto[0]}/{auto[1]} ({sweep[auto]:.3f} ms)  [{power}]")
    del data, zhat
    tc = time.perf_counter()
    spec_c, data_c = par2_workload.build_problem("cpu", torch.float64, K=PAR2_CPU_K)
    init_np = state_to_numpy(init_coupled(spec_c, data_c,
                                          par2_workload.par2_init_options(),
                                          seed=3))
    o3 = par2_workload.par2_options(PAR2_CPU_ITERS, AbsFuncTol=0.0,
                                    OuterRelTol=0.0)
    _, out_cpu = fit(spec_c, data_c, state_from_numpy(init_np, "cpu"), o3)
    t_cpu = time.perf_counter() - tc
    _, data_g = par2_workload.build_problem(dev, torch.float64, K=PAR2_CPU_K)
    _, out_gpu = fit(spec_c, data_g, state_from_numpy(init_np, dev), o3)
    hold_streams(out_gpu, out_cpu, f"PAR2 K={PAR2_CPU_K}")
    print(f"  card vs CPU in float64 at K = {PAR2_CPU_K} slices, "
          f"{PAR2_CPU_ITERS} iterations: the CPU side {t_cpu:.1f} s")
    done(12, t0)

    # ---- 13. the PARAFAC2 surface ---------------------------------------------
    t0 = phase(13, f"PARAFAC2 surface {par2_surface.CONFIGS}, "
                   f"{par2_surface.N_ITERS} outer iterations, float32")
    expect = {"unimodal": "A", "ragged": "A", "tv": "B", "tparafac2": "C",
              "coupled": "mttkrp3"}
    total = dict.fromkeys(counters, 0)
    c_routes = dict.fromkeys(t_smooth_cols.route_launches, 0)
    par2_routes = {"A": dict.fromkeys(project_isotonic_cols.route_launches, 0),
                   "B": dict.fromkeys(prox_tv_cols.route_launches, 0)}
    for config in par2_surface.CONFIGS:
        tc = time.perf_counter()
        spec, data = par2_surface.build_problem(config, dev, torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        state0 = init_coupled(spec, data, par2_surface.surface_init_options(config),
                              generator=gen)
        opts = par2_surface.surface_options(config, par2_surface.N_ITERS,
                                            AbsFuncTol=0.0, OuterRelTol=0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        _, _, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
        n_launch, syncs = counts(), to_host.calls
        for k, v in n_launch.items():
            total[k] += v
        for k, v in t_smooth_cols.route_launches.items():
            c_routes[k] += v
        for name, fn in (("A", project_isotonic_cols), ("B", prox_tv_cols)):
            for k, v in fn.route_launches.items():
                par2_routes[name][k] += v
        lanes_a = project_isotonic_cols.route_launches[prox_cuda.LANES]
        if config in ("unimodal", "ragged") and lanes_a != n_launch["A"]:
            raise RuntimeError(f"PAR2 surface {config}: kernel A routes "
                               f"{project_isotonic_cols.route_launches}")
        if config == "ragged":
            print(f"  ragged: {n_launch['A'] / par2_surface.N_ITERS:.2f} "
                  f"launches of kernel A an iteration, all on the lanes route "
                  f"(one a prox call for the {len(set(spec.par2_slice_sizes(0)))}"
                  f" slice sizes)")
        streams = np.stack([out.func_val_conv, out.func_coupl_conv,
                            out.func_constr_conv, out.func_PAR2_coupl])
        if out.OuterIterations != par2_surface.N_ITERS \
                or not np.all(np.isfinite(streams)):
            raise RuntimeError(f"PAR2 surface {config}: {out.OuterIterations} "
                               "iterations or non-finite streams")
        if n_launch[expect[config]] == 0:
            raise RuntimeError(f"PAR2 surface {config}: kernel "
                               f"{expect[config]} never launched: {n_launch}")
        med, p90 = fit_times(out)
        print(f"{config}: f_tensors {out.func_val_conv[0]:.6e} -> "
              f"{out.f_tensors:.6e}; f_constraints {out.f_constraints:.3e}; "
              f"f_couplings {out.f_couplings:.3e}; f_PAR2_couplings "
              f"{out.f_PAR2_couplings:.3e}")
        print(f"  ms per outer iteration: median {med:.3f}, p90 {p90:.3f}; "
              f"launches {n_launch} ({n_launch[expect[config]] / par2_surface.N_ITERS:.2f}"
              f" of kernel {expect[config]} an iteration); host syncs "
              f"{syncs / par2_surface.N_ITERS:.2f} an iteration; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  "
              f"[{power}]")
        del data, state0
        spec_c, data_c = par2_surface.build_problem(config, "cpu", torch.float64,
                                                    K=PAR2_CPU_K)
        init_np = state_to_numpy(init_coupled(
            spec_c, data_c, par2_surface.surface_init_options(config), seed=4))
        o3 = par2_surface.surface_options(config, PAR2_CPU_ITERS,
                                          AbsFuncTol=0.0, OuterRelTol=0.0)
        if config == "unimodal":
            o3 = dataclasses.replace(o3, iter_start_PAR2Bkconstraint=2)
        tcpu = time.perf_counter()
        _, out_cpu = fit(spec_c, data_c, state_from_numpy(init_np, "cpu"), o3)
        tcpu = time.perf_counter() - tcpu
        _, data_g = par2_surface.build_problem(config, dev, torch.float64,
                                               K=PAR2_CPU_K)
        _, out_gpu = fit(spec_c, data_g, state_from_numpy(init_np, dev), o3)
        hold_streams(out_gpu, out_cpu, f"{config} K={PAR2_CPU_K}")
        print(f"  {config}: {time.perf_counter() - tc:.1f} s, the CPU side "
              f"{tcpu:.1f} s")
    done(13, t0)

    extra = {}
    for name in ("A", "B"):
        t_k, t_b, by = timed[name]
        extra[name] = {"par2_shape": list(PAR2_SHAPE), "par2_ms": t_k,
                       "par2_block_route_ms": block_ms[name],
                       "par2_plain_ms": plain_ms[name], "par2_bound_ms": t_b,
                       "par2_bound_by": by, "par2_max_abs_err": err[name],
                       "par2_launches": total[name],
                       "par2_kernel_routes": par2_routes[name]}
    t_k, t_b, by = timed["C"]
    if c_routes[prox_cuda.STAGED] != total["C"]:
        raise RuntimeError(f"kernel C routes on the surface: {c_routes}")
    return {"batched": extra, "mttkrp3_launches": total["mttkrp3"],
            "C": {"name": "t_smooth_cols", "route": "cuda",
                  "source": T_SMOOTH_SOURCE, "replaces": T_SMOOTH_REPLACES,
                  "launches": total["C"], "max_abs_err": err["C"], "ms": t_k,
                  "plain_ms": plain_ms["C"], "bound_ms": t_b, "bound_by": by,
                  "library_ms": t_lib_c, "kernel_routes": c_routes,
                  "stream_route_ms": t_stream,
                  "recurrence_floor_ms": c_times["float32"]["floor_ms"],
                  "float64": c_times["float64"]}}


def stream_variant(plan, shape, R, sms, stages=None, stage_rows=None,
                   copy=None):
    """The mode-2 stream plan with another ring depth, stage size or copy
    route, its row ranges and shared memory recomputed; stages shrink
    until the ring fits 227 KB."""
    from matlab_code_tpu_torch.ops import mttkrp_cuda as mc
    stages = stages or plan.stages
    stage_rows = stage_rows or plan.stage_rows
    I, J, _ = shape

    def smem(rows):
        return mc.stream_smem(stages, rows, plan.tk, plan.rm, plan.kthreads,
                              plan.phases, R, 4)
    while stage_rows > 1 and smem(stage_rows) > mc.SMEM_MAX:
        stage_rows -= 1
    nsplit, spb = mc._splits(-(-I * J // stage_rows), max(1, sms // plan.ktiles))
    return plan._replace(stages=stages, stage_rows=stage_rows, nsplit=nsplit,
                         spb=spb, smem=smem(stage_rows),
                         copy=plan.copy if copy is None else copy)


def rows_variant(plan, shape, R, sms, ob=None, stages=None, stage_rows=None,
                 copy=None):
    """The modes-0/1 rows-stream plan with other tile rows, ring depth,
    stage size or copy route, its ranges, blocks and shared memory
    recomputed (stages of at most 32 KB of X for other tile rows); stages
    shrink until the ring fits 227 KB."""
    from matlab_code_tpu_torch.ops import mttkrp_cuda as mc
    O, Sn = (shape[0], shape[1]) if plan.mode == 0 else (shape[1], shape[0])
    ob = min(ob or plan.ob, O)
    stages = stages or plan.stages
    n_ot = -(-O // ob)
    ns, per = mc._splits(Sn, max(1, sms // (n_ot * plan.ktiles)))
    rows = max(1, min(stage_rows or (
        plan.stage_rows if ob == plan.ob else
        min(mc._STAGE_BYTES // (ob * plan.tk * 4),
            mc._KR_BYTES // (plan.rm * 4))), per))
    threads = 32 * -(-ob * plan.kthreads // 32)

    copy = plan.copy if copy is None else copy

    def smem(rows):
        return mc.rows_smem(plan.mode, stages, rows, ob, plan.tk, plan.rm,
                            threads, 4, copy)
    while rows > 1 and smem(rows) > mc.SMEM_MAX:
        rows -= 1
    return plan._replace(ob=ob, ns=ns, per=per, stages=stages,
                         nblk=min(ns * n_ot, max(1, sms // plan.ktiles)),
                         stage_rows=rows, smem=smem(rows), copy=copy)


def design_probe(X32, f32, want, shape, R, mode, flush, power):
    """A dense kernel's design choices at one shape, float32: the plan (4
    slots, bulk copies, stages of at most 32 KB of X; in modes 0/1 tiles of
    256 / kthreads output rows) against half tiles (modes 0/1), 3 and 6
    slots, half-size stages (mode 2 also 8 slots of them) and 16-byte
    cp.async, each checked against the float64 plain version and timed;
    the plan is timed first and last."""
    import torch
    from matlab_code_tpu_torch.ops import mttkrp_cuda as mc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = mc.plan_mttkrp3(shape, R, mode, 4, sms)
    half = max(1, plan.stage_rows // 2)
    if mode == 2:
        variant = functools.partial(stream_variant, plan, shape, R, sms)
        cases = [("3 slots", variant(stages=3)), ("6 slots", variant(stages=6)),
                 ("8 slots, half stages", variant(stages=8, stage_rows=half))]
    else:
        variant = functools.partial(rows_variant, plan, shape, R, sms)
        cases = [("half tile rows", variant(ob=max(1, plan.ob // 2))),
                 ("3 slots", variant(stages=3)), ("6 slots", variant(stages=6))]
    cases = ([("plan", plan)] + cases
             + [("half stages", variant(stage_rows=half)),
                ("16-byte cp.async", variant(copy=16)), ("plan, again", plan)])
    ops, _ = mc.kernel_operands(X32, f32, mode)
    gb = X32.numel() * 4 / 1e9
    scale = want.abs().max().item()
    times = {}
    for name, p in cases:
        if p.smem > mc.SMEM_MAX or (p.copy == 16 and plan.copy != 0):
            print(f"  design probe {shape} R={R} mode {mode} {name}: does not "
                  f"fit or apply")
            continue
        err = (mc._launch(X32, ops, mode, p).double() - want).abs().max().item()
        if not err <= 1e-4 * scale:
            raise RuntimeError(f"design probe {name} disagrees: {shape} R={R} "
                               f"mode {mode}")
        t = time_ms(lambda: mc._launch(X32, ops, mode, p), flush)
        times[name] = t
        tiles = f"tiles of {p.ob} rows, " if mode < 2 else ""
        print(f"  design probe {shape} R={R} mode {mode} {name}: {t * 1e3:.1f}"
              f" us ({gb / (t / 1e3):.0f} GB/s; {tiles}{p.stages} slots of "
              f"{p.stage_rows} rows, copy {p.copy}, smem {p.smem})  [{power}]")
    return times


def gh_scale(loss, X, M, eps_log, beta):
    """|first term| + |second term| of gh(X, M), elementwise: the scale
    kernel D's gh is held to (a difference of two rounded terms)."""
    if loss == "KL":
        return 1.0 + (X / (M + eps_log)).abs()
    if loss == "IS":
        return (X / (M + eps_log) ** 2).abs() + (1.0 / (M + eps_log)).abs()
    return (M ** (beta - 1.0)).abs() + (X * M ** (beta - 2.0)).abs()


class fused_counts:
    """Counts, inside the block, on a KL path: the fused kernel's launches
    with and without its MTTKRP (through wrappers of the entries
    ops/losses.py calls), the L-BFGS-B evaluations (lbfgs_bridge's vag,
    through a wrapper of the lbfgsb it calls) and the models torch.einsum
    forms (ktensor_full called by lbfgs_bridge and by the objective)."""

    def __enter__(self):
        from matlab_code_tpu_torch.models import lbfgs_bridge, objective
        from matlab_code_tpu_torch.ops import losses
        self.n = {"grad": 0, "f_only": 0, "evals": 0, "bridge_models": 0,
                  "objective_models": 0}
        self.saved = []

        def patch(mod, name, wrap):
            real = getattr(mod, name)
            self.saved.append((mod, name, real))
            setattr(mod, name, wrap(real))

        def count_launch(real):
            def call(*args, **kwargs):
                grad = kwargs.get("grad", args[6] if len(args) > 6 else True)
                self.n["grad" if grad else "f_only"] += 1
                return real(*args, **kwargs)
            return call

        def count_evals(real):
            def run(vag, *args, **kwargs):
                def counted(x):
                    self.n["evals"] += 1
                    return vag(x)
                return real(counted, *args, **kwargs)
            return run

        def count_models(key):
            def wrap(real):
                def call(*args, **kwargs):
                    self.n[key] += 1
                    return real(*args, **kwargs)
                return call
            return wrap

        patch(losses, "loss_fg_mttkrp_cuda", count_launch)
        patch(losses, "loss_fg_mttkrp_cuda_starts", count_launch)
        patch(lbfgs_bridge, "lbfgsb", count_evals)
        patch(lbfgs_bridge, "ktensor_full", count_models("bridge_models"))
        patch(objective, "ktensor_full", count_models("objective_models"))
        return self.n

    def __exit__(self, *exc):
        for mod, name, real in reversed(self.saved):
            setattr(mod, name, real)
        return False


def fused_problem(shape, R, dt, dev, seed):
    """Factors U(0.1, 1.1) of rank R and Poisson counts of their model, on
    the card in dt."""
    import torch
    from matlab_code_tpu_torch.ops.tensor import ktensor_full
    rng = np.random.default_rng(seed)
    facs = [torch.tensor(rng.uniform(0.1, 1.1, size=(n, R)), device=dev)
            for n in shape]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    X = torch.poisson(ktensor_full(facs), generator=gen)
    return X.to(dt), [F.to(dt) for F in facs]


def check_fused(loss, beta, X, facs, mode, grad, eps):
    """The fused kernel D against its plain version on the same card
    tensors, and against itself called again: (f rel err, G err / scale,
    max |G - plain|, same bits)."""
    import torch
    from matlab_code_tpu_torch.ops import losses
    from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_mttkrp_cuda
    from matlab_code_tpu_torch.ops.tensor import ktensor_full, mttkrp_einsum
    f, G = loss_fg_mttkrp_cuda(loss, X, facs, mode, eps, beta, grad)
    f2, G2 = loss_fg_mttkrp_cuda(loss, X, facs, mode, eps, beta, grad)
    torch.cuda.synchronize()
    f_ref, G_ref = losses.loss_fg_mttkrp_reference(loss, X, facs, mode, eps,
                                                   beta, grad)
    err_f = abs(float(f) - float(f_ref)) / abs(float(f_ref))
    same = bool(torch.equal(f, f2))
    err_g = abs_g = 0.0
    if grad:
        scale = mttkrp_einsum(gh_scale(loss, X, ktensor_full(facs), eps, beta),
                              [F.abs() for F in facs], mode)
        err_g = float(((G - G_ref).abs() / scale).max())
        abs_g = float((G - G_ref).abs().max())
        same = same and bool(torch.equal(G, G2))
    return err_f, err_g, abs_g, same


def kl_phases(dev, power):
    """Phases 14 and 15: kernel D (the fused evaluation and the old pass)
    and the KL workload.  Returns the kernels line's entries of both
    forms of kernel D and mttkrp3's launches on the KL path."""
    import warnings
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops import losses
    from matlab_code_tpu_torch.ops.loss_cuda import (
        loss_fg_cuda, loss_fg_mttkrp_cuda, loss_fg_mttkrp_cuda_starts)
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.tensor import ktensor_full
    from matlab_code_tpu_torch.utils import kl_workload as klw
    from matlab_code_tpu_torch.utils import time_fused

    # ---- 14. kernel D vs plain ------------------------------------------------
    t0 = phase(14, "kernel D vs plain: the fused evaluation and the old pass")
    eps = 1e-10
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    max_abs_err = 0.0
    for shape in LOSS_SHAPES:
        # a positive model and Poisson counts of it (zeros among them)
        M64 = 0.05 + 2.95 * torch.rand(shape, generator=gen, device=dev,
                                       dtype=torch.float64)
        X64 = torch.poisson(M64, generator=gen)
        for dt, rtol_y, rtol_f in zip((torch.float32, torch.float64),
                                      LOSS_RTOL_GH, LOSS_RTOL_F):
            X, M = X64.to(dt), M64.to(dt)
            for loss, beta in LOSS_CASES:
                before = loss_fg_cuda.launches
                f, Y = loss_fg_cuda(loss, X, M, eps, beta)
                torch.cuda.synchronize()
                f_ref, Y_ref = losses.loss_fg_reference(loss, X, M, eps, beta)
                err_y = float(((Y - Y_ref).abs()
                               / gh_scale(loss, X, M, eps, beta)).max())
                err_f = abs(float(f) - float(f_ref)) / abs(float(f_ref))
                f2, Y2 = loss_fg_cuda(loss, X, M, eps, beta)
                same = bool(torch.equal(f2, f) and torch.equal(Y2, Y))
                bits = float((Y == Y_ref).double().mean())
                label = f"{loss}{'' if beta is None else f' {beta}'}"
                print(f"old pass {shape} {dt} {label}: gh max |kernel-plain| / "
                      f"scale {err_y:.3e} (bound {rtol_y:.0e}; {bits:.2%} of "
                      f"elements the same bits); sum fh rel diff {err_f:.3e} "
                      f"(bound {rtol_f:.0e}); same bits on repeat: {same}")
                if not (err_y <= rtol_y and err_f <= rtol_f and same
                        and loss_fg_cuda.launches == before + 2):
                    raise RuntimeError(f"kernel D disagrees: {shape} {dt} "
                                       f"{label}")
                max_abs_err = max(max_abs_err,
                                  float((Y - Y_ref).abs().max()))
        del M64, X64, X, M, Y, Y_ref, Y2
    # the fused evaluation: every loss, modes 0-2 and the f-only pass
    fused_err = 0.0
    for shape, ranks in FUSED_SHAPES:
        for R in ranks:
            for dt, rtol_g, rtol_f in zip((torch.float32, torch.float64),
                                          FUSED_RTOL_G, LOSS_RTOL_F):
                X, facs = fused_problem(shape, R, dt, dev, sum(shape) + R)
                for loss, beta in LOSS_CASES:
                    worst = [0.0, 0.0, True]
                    for mode, grad in ((0, True), (1, True), (2, True),
                                       (0, False)):
                        before = loss_fg_mttkrp_cuda.launches
                        e_f, e_g, a_g, same = check_fused(
                            loss, beta, X, facs, mode, grad, eps)
                        worst = [max(worst[0], e_f), max(worst[1], e_g),
                                 worst[2] and same]
                        fused_err = max(fused_err, a_g)
                        if not (e_f <= rtol_f and e_g <= rtol_g and same and
                                loss_fg_mttkrp_cuda.launches == before + 2):
                            raise RuntimeError(
                                f"fused kernel D disagrees: {shape} R {R} {dt} "
                                f"{loss} {beta} mode {mode} grad {grad}: f "
                                f"{e_f:.3e}, G {e_g:.3e}, same bits {same}")
                    label = f"{loss}{'' if beta is None else f' {beta}'}"
                    print(f"fused {shape} R {R} {dt} {label}, modes 0-2 and "
                          f"f alone: sum fh rel diff {worst[0]:.3e} (bound "
                          f"{rtol_f:.0e}); G max |kernel-plain| / scale "
                          f"{worst[1]:.3e} (bound {rtol_g:.0e}); same bits on "
                          f"repeat: {worst[2]}")
                del X, facs
    # each start's bits those of its own launch, X shared and one a start
    S = 3
    for dt in (torch.float32, torch.float64):
        Xs, facs = zip(*[fused_problem((37, 50, 29), 8, dt, dev, 140 + s)
                         for s in range(S)])
        Fs = [torch.stack([f[d] for f in facs]) for d in range(3)]
        for X in (Xs[0], torch.stack(Xs)):
            for mode in range(3):
                before = loss_fg_mttkrp_cuda.launches
                f, G = loss_fg_mttkrp_cuda_starts("IS", X, Fs, mode, eps)
                one = loss_fg_mttkrp_cuda.launches == before + 1
                for s in range(S):
                    f1, G1 = loss_fg_mttkrp_cuda(
                        "IS", X if X.dim() == 3 else X[s],
                        [F[s] for F in Fs], mode, eps)
                    if not (one and torch.equal(f1, f[s])
                            and torch.equal(G1, G[s])):
                        raise RuntimeError(f"fused kernel D, start {s} of {S} "
                                           f"({dt}, mode {mode}): not the bits "
                                           f"of its own launch")
    print(f"fused on the start axis: {S} starts in one launch, X shared and "
          f"one a start, modes 0-2, float32 and float64: each start's f and G "
          f"the bits of its own launch")
    # timed at the KL workload's data and the model of its init
    spec, data, state0, _ = klw.build_problem(dev, torch.float32)
    X = data.objects[0]
    facs = list(state0.fac)
    M = ktensor_full(facs).contiguous()
    n = X.numel()
    R = spec.datasets[0].rank
    flush = l2_flush(dev)
    t_b, by = bound(12 * n, 6 * n)   # X, M read, Y written; ~6 ops (KL)
    t_k = time_ms(lambda: loss_fg_cuda("KL", X, M, eps), flush)
    t_p = time_ms(lambda: losses.loss_fg_reference("KL", X, M, eps), flush)
    _, Y = loss_fg_cuda("KL", X, M, eps)

    def evaluation(mode):
        Mx = ktensor_full(facs).contiguous()
        _, Yx = loss_fg_cuda("KL", X, Mx, eps)
        return mttkrp3(Yx, facs, mode)

    t_e = [time_ms(lambda: evaluation(mode), flush) for mode in range(3)]
    t_m = time_ms(lambda: ktensor_full(facs).contiguous(), flush)
    t_g = [time_ms(lambda: mttkrp3(Y, facs, mode), flush) for mode in range(3)]
    t_fm = [time_ms(lambda: loss_fg_mttkrp_cuda("KL", X, facs, mode, eps),
                    flush) for mode in range(3)]
    t_f0 = time_ms(lambda: loss_fg_mttkrp_cuda("KL", X, facs, 0, eps,
                                               grad=False), flush)
    t_pf = time_ms(lambda: losses.loss_fg_mttkrp_reference("KL", X, facs, 0,
                                                           eps), flush)
    # X once, the factors read and G written; the model 2R - 1, the MTTKRP
    # 2R and ~6 operations of fh and gh an element (KL)
    io = 4 * (n + sum(F.numel() for F in facs) + X.shape[0] * R)
    t_fb, fby = bound(io, n * (4 * R + 5))
    t_f0b, _ = bound(4 * (n + sum(F.numel() for F in facs)), n * (2 * R + 5))
    print(f"KL at {tuple(X.shape)} float32: old pass {t_k * 1e3:.1f} us "
          f"({12 * n / 1e6 / t_k:.0f} GB/s, {t_b / t_k:.1%} of the bound) | "
          f"bound {t_b * 1e3:.1f} us ({by}) | plain {t_p * 1e3:.1f} us  "
          f"[{power}]")
    print(f"  the three-call evaluation (model by torch.einsum, the old pass, "
          f"mttkrp3) modes 0/1/2 {' / '.join(f'{t * 1e3:.1f}' for t in t_e)} "
          f"us; the model alone {t_m * 1e3:.1f} us; mttkrp3 of gh modes 0/1/2 "
          f"{' / '.join(f'{t * 1e3:.1f}' for t in t_g)} us  [{power}]")
    print(f"  the fused evaluation (one launch) modes 0/1/2 "
          f"{' / '.join(f'{t * 1e3:.1f}' for t in t_fm)} us, f alone "
          f"{t_f0 * 1e3:.1f} us; bound {t_fb * 1e3:.1f} us ({fby}; f alone "
          f"{t_f0b * 1e3:.1f}); {np.mean(t_e) / np.mean(t_fm):.2f}x the "
          f"three-call evaluation; plain version (mode 0) {t_pf * 1e3:.1f} us  "
          f"[{power}]")
    # the fused call against the three-call evaluation over ranks and
    # dtypes (the route choice of losses.takes_fused), device time beside
    # the events; at R 8 float32 the fused beta-2 call (no division, no
    # log), the f-only pass and X.sum() (one read of X by a library call)
    grid = time_fused.route_grid(dev, flush, FUSED_TIMED_RANKS,
                                 (torch.float32, torch.float64))
    for r in grid:
        print(f"  {r['dtype']} R {r['R']} mode {r['mode']}: fused "
              f"{r['fused_ms'] * 1e3:.1f} us ({r['fused_dev_us']:.1f} device), "
              f"three-call {r['three_ms'] * 1e3:.1f} us "
              f"({r['three_dev_us']:.1f} device), device time fused / "
              f"three-call {r['fused_dev_us'] / r['three_dev_us']:.2f}x  "
              f"[{power}]")
    dev_ratio = {}
    for dt, cap in losses.FUSED_MAX_RANK.items():
        name = str(dt).replace("torch.", "")
        for rank in FUSED_TIMED_RANKS:
            rows = [r for r in grid if r["dtype"] == name and r["R"] == rank]
            dev_ratio[name, rank] = (
                np.mean([r["fused_dev_us"] for r in rows])
                / np.mean([r["three_dev_us"] for r in rows]))
        print(f"  route ({name}: fused up to R {cap}, losses.FUSED_MAX_RANK): "
              f"device time fused / three-call, mean of modes 0-2: " + ", ".join(
                  f"R {rank} {dev_ratio[name, rank]:.2f}x "
                  f"({'fused' if rank <= cap else 'three calls'})"
                  for rank in FUSED_TIMED_RANKS))
    probe = time_fused.probes(dev, flush)
    print("  R 8 float32 mode 0: " + ", ".join(
        f"{k} {ms * 1e3:.1f} us ({us:.1f} device)"
        for k, (ms, us) in probe.items()) + f"  [{power}]")
    del flush, M, Y
    done(14, t0)

    # ---- 15. the KL workload --------------------------------------------------
    t0 = phase(15, f"KL workload, {KL_ITERS} outer iterations, float32")
    print(f"X {tuple(X.shape)} Poisson counts ({n * 4 / 1e6:.1f} MB), rank "
          f"{R}, max count {float(X.max()):.0f}")
    opts = klw.kl_options(KL_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_fg_cuda.launches = mttkrp3.launches = to_host.calls = 0
    loss_fg_mttkrp_cuda.launches = 0
    to_host.seconds = 0.0
    with fused_counts() as c:
        zhat, _, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
    n_d, n_m, n_f = (loss_fg_cuda.launches, mttkrp3.launches,
                     loss_fg_mttkrp_cuda.launches)
    syncs, sync_s = to_host.calls, to_host.seconds
    streams = np.stack([out.func_val_conv, out.func_coupl_conv,
                        out.func_constr_conv, out.func_PAR2_coupl])
    if out.OuterIterations != KL_ITERS or not np.all(np.isfinite(streams)) \
            or not out.func_val_conv[-1] < out.func_val_conv[0]:
        raise RuntimeError(f"KL workload: {out.OuterIterations} iterations, "
                           f"f_tensors {out.func_val_conv}")
    if [f.shape for f in zhat[0]["factors"]] != [(d, R) for d in X.shape] \
            or min(float(f.min()) for f in zhat[0]["factors"]) < 0:
        raise RuntimeError("KL workload: unexpected or negative factors")
    check_fused_path("KL workload", c, n_f, n_d, n_m, KL_ITERS)
    med, p90 = fit_times(out)
    lb = out.lbfgsb_iterations
    print(f"f_tensors {out.func_val_conv[0]:.6e} -> {out.f_tensors:.6e}; "
          f"f_constraints {out.f_constraints:.3e}")
    print(f"ms per outer iteration: median {med:.3f}, p90 {p90:.3f}; device "
          f"reads {syncs / KL_ITERS:.2f} an iteration ({syncs} in all, the "
          f"data check's one included), {sync_s * 1e3:.1f} ms waiting in "
          f"them = {sync_s / out.time_total:.1%} of the "
          f"{out.time_total * 1e3:.1f} ms fit; launches an iteration: fused "
          f"kernel D {n_f / KL_ITERS:.2f} ({c['evals'] / KL_ITERS:.2f} "
          f"L-BFGS-B evaluations, one launch each; {c['f_only']} objective "
          f"passes), old pass {n_d}, mttkrp3 {n_m}, models by torch.einsum "
          f"{c['bridge_models'] + c['objective_models']}; L-BFGS-B "
          f"iterations by iteration {lb.sum(axis=0)[1:].tolist()} (by mode "
          f"{lb.sum(axis=1).tolist()}); inner iterations "
          f"{out.innerIters.sum(axis=0)[1:].tolist()}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  [{power}]")
    profile_fit(spec, data, state0,
                klw.kl_options(2, AbsFuncTol=0.0, OuterRelTol=0.0))
    del data, zhat
    # the same in float64, where the default factr (1e-6 / float64's eps)
    # lets L-BFGS-B run past its first iteration (float32's eps makes it a
    # relative change of 537: every run stops after one iteration)
    spec, data, state0, _ = klw.build_problem(dev, torch.float64)
    loss_fg_cuda.launches = mttkrp3.launches = to_host.calls = 0
    loss_fg_mttkrp_cuda.launches = 0
    to_host.seconds = 0.0
    with fused_counts() as c:
        _, _, _, out = cmtf_aoadmm(spec, data, opts, init=state0)
    check_fused_path("KL workload, float64", c, loss_fg_mttkrp_cuda.launches,
                     loss_fg_cuda.launches, mttkrp3.launches, KL_ITERS)
    med, p90 = fit_times(out)
    if not np.all(np.isfinite(out.func_val_conv)):
        raise RuntimeError("KL workload, float64: non-finite f_tensors")
    print(f"  float64: ms per outer iteration median {med:.3f}, p90 {p90:.3f}; "
          f"device reads {to_host.calls / KL_ITERS:.2f} an iteration, "
          f"{to_host.seconds / out.time_total:.1%} of the wall clock; fused "
          f"kernel D {loss_fg_mttkrp_cuda.launches / KL_ITERS:.2f} an "
          f"iteration ({c['evals']} evaluations); L-BFGS-B "
          f"iterations by iteration "
          f"{out.lbfgsb_iterations.sum(axis=0)[1:].tolist()}; f_tensors "
          f"{out.func_val_conv[0]:.6e} -> {out.f_tensors:.6e}  [{power}]")
    del data, state0
    # the card against the CPU in float64 at script 07's widths
    tc = time.perf_counter()
    spec7, data_c = klw.script07_problem("cpu", torch.float64, seed=S07_SEED)
    init_np = state_to_numpy(init_coupled(spec7, data_c,
                                          klw.script07_init_options(), seed=2))
    o3 = klw.script07_options(S07_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, data_g = klw.script07_problem(dev, torch.float64, seed=S07_SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the data are not counts
        _, out_cpu = fit(spec7, data_c, state_from_numpy(init_np, "cpu"), o3)
        init_g = state_from_numpy(init_np, dev)
        loss_fg_cuda.launches = mttkrp3.launches = 0
        loss_fg_mttkrp_cuda.launches = 0
        with fused_counts() as c:
            _, out_gpu = fit(spec7, data_g, init_g, o3)
    n_d7, n_m7, n_f7 = (loss_fg_cuda.launches, mttkrp3.launches,
                        loss_fg_mttkrp_cuda.launches)
    # the tensor's evaluations take the fused kernel, one launch each; the
    # matrix's keep the model by torch.einsum and the old pass
    print(f"  script 07 on the card: {c['evals']} L-BFGS-B evaluations, "
          f"{c['grad']} of them fused (one launch each) and "
          f"{c['bridge_models']} of the matrix (a model each); fused launches "
          f"{n_f7} ({c['f_only']} objective passes), old pass {n_d7}, mttkrp3 "
          f"{n_m7}")
    if not (c["grad"] > 0 and n_f7 == c["grad"] + c["f_only"]
            and c["grad"] + c["bridge_models"] == c["evals"]
            and c["f_only"] > 0 and n_d7 > 0 and n_m7 == 0):
        raise RuntimeError(f"script 07 on the card: fused {n_f7}, old pass "
                           f"{n_d7}, mttkrp3 {n_m7}, counts {c}")
    same_inner = np.array_equal(out_gpu.innerIters, out_cpu.innerIters)
    same_lb = np.array_equal(out_gpu.lbfgsb_iterations,
                             out_cpu.lbfgsb_iterations)
    print(f"  script 07, {S07_ITERS} iterations: inner iterations equal "
          f"{same_inner}, L-BFGS-B iterations equal {same_lb} (card "
          f"{out_gpu.lbfgsb_iterations.sum(axis=1).tolist()}, CPU "
          f"{out_cpu.lbfgsb_iterations.sum(axis=1).tolist()} by mode)")
    hold_streams(out_gpu, out_cpu, "script 07")
    if not (same_inner and same_lb):
        raise RuntimeError("script 07: the card's inner or L-BFGS-B iteration "
                           "counts differ from the CPU's")
    print(f"  card vs CPU in float64: {time.perf_counter() - tc:.1f} s")
    done(15, t0)
    return {"mttkrp3_launches": n_m,
            "D": {"name": "loss_fg_cuda", "route": "cuda",
                  "source": LOSS_SOURCE, "replaces": LOSS_REPLACES,
                  "launches": n_d7, "max_abs_err": max_abs_err, "ms": t_k,
                  "plain_ms": t_p, "bound_ms": t_b, "bound_by": by,
                  "library_ms": None, "evaluation_ms": float(np.mean(t_e))},
            "fused": {"name": "loss_fg_mttkrp_cuda", "route": "cuda",
                      "source": FUSED_SOURCE, "replaces": FUSED_REPLACES,
                      "launches": n_f, "max_abs_err": fused_err,
                      "ms": float(np.mean(t_fm)),
                      "mode_ms": t_fm, "f_only_ms": t_f0, "plain_ms": t_pf,
                      "bound_ms": t_fb, "bound_by": fby, "library_ms": None,
                      "three_call_ms": float(np.mean(t_e)),
                      "device_ms": np.mean([
                          r["fused_dev_us"] for r in grid
                          if r["dtype"] == "float32" and r["R"] == R]) / 1e3,
                      "three_call_device_ms": np.mean([
                          r["three_dev_us"] for r in grid
                          if r["dtype"] == "float32" and r["R"] == R]) / 1e3,
                      "route_grid": grid, "probes": probe,
                      "script07_launches": n_f7}}


def check_fused_path(label, c, n_f, n_d, n_m, iters):
    """A KL path of an uncut dense 3-way dataset on the card: every
    L-BFGS-B evaluation one launch of the fused kernel D, every objective
    pass one f-only launch, no old pass, no mttkrp3 and no model formed by
    torch.einsum (c: fused_counts' counts of the run)."""
    print(f"  {label}: {c['evals']} L-BFGS-B evaluations, fused launches "
          f"{n_f} ({c['grad']} with G, {c['f_only']} f alone), old pass "
          f"{n_d}, mttkrp3 {n_m}, models by torch.einsum "
          f"{c['bridge_models'] + c['objective_models']}")
    if not (c["evals"] > 0 and c["grad"] == c["evals"]
            and c["f_only"] >= iters and n_f == c["grad"] + c["f_only"]
            and n_d == 0 and n_m == 0
            and c["bridge_models"] + c["objective_models"] == 0):
        raise RuntimeError(f"{label}: not one fused launch an evaluation "
                           f"(fused {n_f}, old pass {n_d}, mttkrp3 {n_m}, "
                           f"counts {c})")


def pp_counts():
    """(first approximated sweep, approximated sweeps, rebuilds) of the
    pairwise gate since its counts were reset."""
    from matlab_code_tpu_torch.models import pairwise
    u = pairwise.pp_sweep_update
    return u.first_active, u.active, u.rebuilds


def pp_probe(label, spec, data, state, dev, power):
    """Where a PP sweep's device time goes on dataset 0: one rebuild of the
    three partials and the three first-order MTTKRPs (partials laid out
    (R, a, b), as models/pairwise.py keeps them, and, as a design probe,
    (a, b, R), the JAX package's layout) against the exact MTTKRPs, each
    beside its bytes bound (each input read once, each output written
    once), factors 1 % off the references."""
    import torch
    from matlab_code_tpu_torch.models import pairwise
    from matlab_code_tpu_torch.ops.tensor import mttkrp, mttkrp_sparse
    from matlab_code_tpu_torch.problem import SparseTensor
    from matlab_code_tpu_torch.models.solver import attach_sparse_plans
    from matlab_code_tpu_torch.options import AlgOptions
    ds = spec.datasets[0]
    X = attach_sparse_plans(spec, data, AlgOptions()).objects[0]
    dims = [spec.mode_sizes[m] for m in ds.modes]
    R = ds.rank
    refs = tuple(state.fac[m] for m in ds.modes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    facs = tuple(f * (1 + 0.01 * torch.randn(f.shape, generator=gen, device=dev))
                 for f in refs)
    flush = l2_flush(dev)
    t_build = time_ms(lambda: pairwise._build_partials(spec, data, 0, refs),
                      flush, runs=5)
    parts = pairwise._build_partials(spec, data, 0, refs)
    cache = dict(zip(("T01", "T02", "T12"), parts), ref0=refs[0], ref1=refs[1],
                 ref2=refs[2], active=True, seeded=True)
    t_pp = time_ms(lambda: [pairwise.pp_mttkrp(spec, X, facs, 0, cache, local)
                            for local in range(3)], flush)
    abr = [T.permute(1, 2, 0).contiguous() for T in parts]
    eqs = (("ijr,jr->ir", "ikr,kr->ir"), ("ijr,ir->jr", "jkr,kr->jr"),
           ("ikr,ir->kr", "jkr,jr->kr"))
    pairs = ((0, 1), (0, 2), (1, 2))    # the partials each mode reads
    diffs = (facs[2] - refs[2], facs[2] - refs[2], facs[1] - refs[1])

    def pp_abr():
        return [torch.einsum(eqs[l][0], abr[pairs[l][0]], facs[(1, 0, 0)[l]])
                + torch.einsum(eqs[l][1], abr[pairs[l][1]], diffs[l])
                for l in range(3)]

    t_abr = time_ms(pp_abr, flush)
    err = max(float((a - pairwise.pp_mttkrp(spec, X, facs, 0, cache, l)).abs().max())
              for l, a in enumerate(pp_abr()))
    if isinstance(X, SparseTensor):
        exact = lambda: [mttkrp_sparse(X.indices, X.values, list(facs), l, dims[l],
                                       plan=None if X.plans is None
                                       else X.plans[l]) for l in range(3)]
        in_bytes = X.values.numel() * (4 + 4 * X.indices.shape[1])
    else:
        exact = lambda: [mttkrp(X, list(facs), l) for l in range(3)]
        in_bytes = X.numel() * 4
    t_exact = time_ms(exact, flush)
    fac_bytes = sum(d * R * 4 for d in dims)
    part_bytes = [T.numel() * 4 for T in parts]
    b_build = in_bytes + fac_bytes + sum(part_bytes)
    b_pp = sum(part_bytes[a] + part_bytes[b] for a, b in pairs) + 3 * fac_bytes
    b_exact = 3 * (in_bytes + fac_bytes)
    print(f"  {label} dataset 0 {tuple(dims)} R {R}: rebuild of the partials "
          f"{t_build:.3f} ms (bound {b_build / HBM_BYTES_S * 1e3:.3f}); three "
          f"PP MTTKRPs {t_pp:.3f} ms (bound {b_pp / HBM_BYTES_S * 1e3:.3f}; "
          f"(a, b, R) layout {t_abr:.3f} ms, max |diff| {err:.2e}); three exact "
          f"MTTKRPs {t_exact:.3f} ms (bound {b_exact / HBM_BYTES_S * 1e3:.3f})  "
          f"[{power}]")
    del parts, abr, cache, flush


def em_phases(dev, power):
    """Phases 16-18: EM imputation, the pairwise-perturbation MTTKRP,
    fit_stepwise and checkpoints.  Returns the launches of mttkrp3 and of
    the sparse kernel on these paths for the kernels line."""
    import tempfile
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models import pairwise
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit, fit_stepwise
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.sparse_cuda import mttkrp_sparse_cuda
    from matlab_code_tpu_torch.options import AlgOptions
    from matlab_code_tpu_torch.state import FIELDS
    from matlab_code_tpu_torch.utils import (
        em_workload as emw, flagship, par2_workload, sparse_workload)
    from matlab_code_tpu_torch.utils.checkpoint import load_state, save_state
    counts = {}

    # ---- 16. EM imputation ------------------------------------------------------
    t0 = phase(16, f"EM: the flagship ({EM_ITERS} iterations) and the PAR2 "
                   f"K=512 workload ({EM_PAR2_ITERS}) with 20 % missing, "
                   f"float32; script 12's widths on the card and the CPU")
    for label, build, opts, init_opts in (
            ("EM flagship", emw.build_flagship,
             flagship.flagship_options(EM_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0),
             flagship.flagship_init_options()),
            ("EM PAR2 K=512", emw.build_par2,
             par2_workload.par2_options(EM_PAR2_ITERS, AbsFuncTol=0.0,
                                        OuterRelTol=0.0),
             par2_workload.par2_init_options())):
        n = opts.MaxOuterIters
        spec, data = build(dev, torch.float32)
        missing = [round(1 - float(m.float().mean()), 4) for m in data.miss]
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mttkrp3.launches = to_host.calls = 0
        _, _, state0, out = cmtf_aoadmm(spec, data, opts, init_options=init_opts,
                                        generator=gen)
        launches, syncs = mttkrp3.launches, to_host.calls
        streams = np.stack([out.func_val_conv, out.func_coupl_conv,
                            out.func_constr_conv, out.func_PAR2_coupl])
        frm = out.func_rel_missing
        if out.OuterIterations != n or not np.all(np.isfinite(streams)) \
                or frm is None or not np.isnan(frm[0]) \
                or not np.all(np.isfinite(frm[1:])) \
                or not out.func_val_conv[-1] < out.func_val_conv[0]:
            raise RuntimeError(f"{label}: {out.OuterIterations} iterations, "
                               f"f_tensors {out.func_val_conv[[0, -1]]}, "
                               f"f_rel_missing {frm}")
        three_way = sum(1 for X in data.objects if getattr(X, "dim", None)
                        and X.dim() == 3)
        if launches != 3 * three_way * n:
            raise RuntimeError(f"{label}: {launches} mttkrp3 launches in {n} "
                               f"iterations, {3 * three_way * n} expected")
        med, p90 = fit_times(out)
        print(f"{label}: datasets {[tuple(getattr(X, 'slices', X).shape) for X in data.objects]}, "
              f"missing {missing}; f_tensors {out.func_val_conv[0]:.6e} -> "
              f"{out.f_tensors:.6e}; f_rel_missing at iteration 1 {frm[1]:.6e}, "
              f"at {n} {frm[-1]:.6e}")
        print(f"  ms per outer iteration: median {med:.3f}, p90 {p90:.3f}; host "
              f"syncs {syncs / n:.2f} an iteration; mttkrp3 launches "
              f"{launches / n:.2f} an iteration (all on imputed tensors); peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
              f"MiB  [{power}]")
        profile_fit(spec, data, state0, dataclasses.replace(opts, MaxOuterIters=2))
        counts[label] = launches
        del data, state0
    # the card against the CPU in float64 at script 12's widths
    spec, data_c, _, init_opts = emw.script12_problem("cpu", torch.float64)
    _, data_g, _, _ = emw.script12_problem(dev, torch.float64)
    init_np = state_to_numpy(init_coupled(spec, data_c, init_opts, seed=2))
    o3 = AlgOptions(MaxOuterIters=EM_CPU_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_cpu = fit(spec, data_c, state_from_numpy(init_np, "cpu"), o3)
    before = mttkrp3.launches
    _, out_gpu = fit(spec, data_g, state_from_numpy(init_np, dev), o3)
    if mttkrp3.launches == before:
        raise RuntimeError("script 12's widths: mttkrp3 not launched")
    hold_streams(out_gpu, out_cpu, "script 12")
    rel = np.nanmax(np.abs(out_gpu.func_rel_missing - out_cpu.func_rel_missing)
                    / np.abs(out_cpu.func_rel_missing))
    print(f"  script 12 f_rel_missing: card {out_gpu.func_rel_missing[-1]:.12e} "
          f"cpu {out_cpu.func_rel_missing[-1]:.12e} max rel diff {rel:.3e} "
          f"(bound 1e-8)")
    np.testing.assert_allclose(out_gpu.func_rel_missing, out_cpu.func_rel_missing,
                               rtol=1e-8, atol=0, err_msg="script 12 f_rel_missing")
    if not np.array_equal(out_gpu.innerIters, out_cpu.innerIters):
        raise RuntimeError("script 12: the card's inner iterations differ")
    print(f"  script 12, {EM_CPU_ITERS} iterations: inner iterations equal True")
    done(16, t0)

    # ---- 17. the pairwise-perturbation MTTKRP -----------------------------------
    t0 = phase(17, f"pairwise perturbation: the flagship ({PP_ITERS} "
                   f"iterations) and the sparse workload ({PP_SPARSE_ITERS}) in "
                   f"turns with the exact fit, float32; small problems on the "
                   f"card and the CPU")
    for label, build, options, init_opts, n, kernel in (
            ("flagship", lambda: flagship.build_problem(dev, torch.float32),
             flagship.flagship_options, flagship.flagship_init_options(),
             PP_ITERS, mttkrp3),
            ("sparse workload", lambda: sparse_workload.build_problem(
                device=dev, dtype=torch.float32), sparse_workload.sparse_options,
             sparse_workload.sparse_init_options(), PP_SPARSE_ITERS,
             mttkrp_sparse_cuda)):
        spec, data = build()
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        init_np = state_to_numpy(init_coupled(spec, data, init_opts,
                                              generator=gen))
        runs = {}
        for pp in (False, True, True, False):
            opts = options(n, AbsFuncTol=0.0, OuterRelTol=0.0,
                           cp_pairwise_perturbation=pp)
            pairwise.reset_counts()
            kernel.launches = to_host.calls = 0
            state, out = fit(spec, data,
                             state_from_numpy(init_np, dev, torch.float32), opts)
            if out.OuterIterations != n or not np.isfinite(out.f_tensors):
                raise RuntimeError(f"{label}, pp {pp}: {out.OuterIterations} "
                                   f"iterations, f_tensors {out.f_tensors}")
            runs.setdefault(pp, []).append(
                (fit_times(out) + (out.time_total / n * 1e3,), pp_counts(),
                 kernel.launches, out.f_tensors, to_host.calls / n))
        (ex1, ex2), (pp1, pp2) = runs[False], runs[True]
        first, active, rebuilds = pp1[1]
        print(f"{label}: ms per outer iteration (median, p90, mean) "
              + ", ".join(f"{name} {r[0][0]:.3f}/{r[0][1]:.3f}/{r[0][2]:.3f}"
                          for name, r in (("exact", ex1), ("PP", pp1),
                                          ("PP", pp2), ("exact", ex2)))
              + f"; host syncs an iteration exact {ex1[4]:.2f}, PP "
              f"{pp1[4]:.2f}  [{power}]")
        pp_probe(label, spec, data, state, dev, power)
        print(f"  PP first active sweep {first}, active sweeps {active} of {n}, "
              f"rebuilds {rebuilds}; {kernel.__name__} launches: exact "
              f"{ex1[2]}, PP {pp1[2]}; exact final f_tensors: PP {pp1[3]:.9e}, "
              f"exact {ex1[3]:.9e} (rel diff "
              f"{abs(pp1[3] - ex1[3]) / abs(ex1[3]):.3e})")
        if first is None:
            print(f"  finding: PP never switched on in {n} iterations at the "
                  f"default tolerances (pp_start_tol 0.02)")
        if ex1[2] == 0 or pp1[2] == 0:
            raise RuntimeError(f"{label}: {kernel.__name__} not launched on the "
                               f"exact sweeps")
        if pp1[1] != pp2[1]:
            raise RuntimeError(f"{label}: the two PP runs gated differently: "
                               f"{pp1[1]} and {pp2[1]}")
        counts[f"pp {label}"] = pp1[2]
        del data
    for layout, kernel in (("dense", mttkrp3), ("sparse", mttkrp_sparse_cuda)):
        spec, data_c, init_opts = emw.pp_problem(layout, "cpu")
        _, data_g, _ = emw.pp_problem(layout, dev)
        init_np = state_to_numpy(init_coupled(spec, data_c, init_opts, seed=1))
        opts = AlgOptions(MaxOuterIters=PP_SMALL_ITERS, AbsFuncTol=0.0,
                          OuterRelTol=0.0, cp_pairwise_perturbation=True)
        pairwise.reset_counts()
        _, out_cpu = fit(spec, data_c, state_from_numpy(init_np, "cpu"), opts)
        cpu_counts = pp_counts()
        pairwise.reset_counts()
        before = kernel.launches
        _, out_gpu = fit(spec, data_g, state_from_numpy(init_np, dev), opts)
        gpu_counts = pp_counts()
        print(f"  small {layout}, {PP_SMALL_ITERS} iterations: (first active, "
              f"active, rebuilds) card {gpu_counts} cpu {cpu_counts}; "
              f"{kernel.__name__} launches {kernel.launches - before}")
        hold_streams(out_gpu, out_cpu, f"small {layout} PP")
        if gpu_counts != cpu_counts or cpu_counts[0] is None \
                or kernel.launches == before:
            raise RuntimeError(f"small {layout} PP: the card gated differently "
                               f"from the CPU, or PP never switched on")
    done(17, t0)

    # ---- 18. fit_stepwise and checkpoints ------------------------------------
    t0 = phase(18, f"fit_stepwise against fit on the flagship ({STEP_ITERS} "
                   f"iterations, float32); a checkpoint after {CKPT_ITERS}")
    spec, data = flagship.build_problem(dev, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    init_np = state_to_numpy(init_coupled(spec, data, flagship.flagship_init_options(),
                                          generator=gen))
    opts = flagship.flagship_options(STEP_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, o_fit = fit(spec, data, state_from_numpy(init_np, dev, torch.float32), opts)
    _, o_sw = fit_stepwise(spec, data, state_from_numpy(init_np, dev, torch.float32),
                           opts)
    same = all(np.array_equal(getattr(o_fit, k), getattr(o_sw, k)) for k in (
        "func_val_conv", "func_coupl_conv", "func_constr_conv", "func_PAR2_coupl"))
    rel = np.max(np.abs(o_sw.func_val_conv - o_fit.func_val_conv)
                 / np.abs(o_fit.func_val_conv))
    print(f"fit {o_fit.OuterIterations} / fit_stepwise {o_sw.OuterIterations} "
          f"iterations; streams bit-equal {same} (f_tensors max rel diff "
          f"{rel:.3e}); ms per iteration median fit {fit_times(o_fit)[0]:.3f}, "
          f"fit_stepwise {fit_times(o_sw)[0]:.3f}  [{power}]")
    if o_fit.OuterIterations != o_sw.OuterIterations \
            or not np.array_equal(o_fit.innerIters, o_sw.innerIters) \
            or not rel <= 1e-6 or not np.all(np.diff(o_sw.time_at_it) >= 0):
        raise RuntimeError("fit_stepwise disagrees with fit on the flagship")
    state, _ = fit(spec, data, state_from_numpy(init_np, dev, torch.float32),
                   flagship.flagship_options(CKPT_ITERS, AbsFuncTol=0.0,
                                             OuterRelTol=0.0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_state(path, state)
        back = load_state(path)
    n_fields = 0
    for f in FIELDS:
        for a, b in zip(getattr(state, f), getattr(back, f)):
            if (a is None) != (b is None) or (a is not None and not (
                    b.device.type == "cuda" and b.dtype == a.dtype
                    and torch.equal(a, b))):
                raise RuntimeError(f"checkpoint: field {f} differs")
            n_fields += a is not None
    print(f"checkpoint after {CKPT_ITERS} iterations: {n_fields} arrays "
          f"bit-equal on the card after load_state")
    done(18, t0)
    return counts


def multistart_phase(dev, power):
    """Phase 19: fit_multistart, the starts on one start axis.  Returns the
    mttkrp3 launches of its flagship run for the kernels line."""
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.multistart import _fit_lanes, fit_multistart
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3, mttkrp3_reference
    from matlab_code_tpu_torch.ops.tensor import mttkrp_columns
    from matlab_code_tpu_torch.utils import multistart_workload as mw

    t0 = phase(19, f"fit_multistart: the flagship with {MS_STARTS} starts "
                   f"({MS_ITERS} iterations, float32) against one start's fit; "
                   f"one batched mttkrp3 call; script 15's widths, "
                   f"{MS_S15_STARTS} starts, on the card and the CPU")
    # one mttkrp3 call with the starts' columns side by side against each
    # start's plain MTTKRP in float64, at the flagship's tensor shapes
    flush = l2_flush(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    for shape, R in FLAGSHIP_SHAPES:
        X = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
        F = [torch.rand((MS_STARTS, n, R), generator=gen, device=dev,
                        dtype=torch.float64) for n in shape]
        X32, F32 = X.float(), [f.float() for f in F]
        for mode in range(3):
            mttkrp3.launches = 0
            got = mttkrp_columns(X, F, mode)
            n_l = mttkrp3.launches
            want = torch.stack([mttkrp3_reference(X, [f[s] for f in F], mode)
                                for s in range(MS_STARTS)])
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            t_wide = time_ms(lambda: mttkrp_columns(X32, F32, mode), flush)
            t_each = time_ms(lambda: [mttkrp3(X32, [f[s] for f in F32], mode)
                                      for s in range(MS_STARTS)], flush)
            print(f"{shape} {MS_STARTS} starts x R {R}, mode {mode}: one call, "
                  f"{n_l} launches (ceil({MS_STARTS * R}/32)); max|wide-plain| "
                  f"{err:.3e} (bound {1e-12 * scale:.3e}); float32 {t_wide * 1e3:.1f}"
                  f" us against {MS_STARTS} calls of R {R} {t_each * 1e3:.1f} us  "
                  f"[{power}]")
            if n_l != -(-MS_STARTS * R // 32) or not err <= 1e-12 * scale:
                raise RuntimeError(f"the batched mttkrp3 call disagrees: {shape} "
                                   f"mode {mode}")
        del X, F, X32, F32
    del flush

    # the flagship: one start's fit, the starts together, one start's fit
    spec, data, opts, init = mw.flagship_problem(dev, torch.float32, MS_ITERS)
    opts = dataclasses.replace(opts, AbsFuncTol=0.0, OuterRelTol=0.0)
    inits = sum(-(-MS_STARTS * ds.rank // 32) for p, ds in
                enumerate(spec.datasets) if data.objects[p].dim() == 3)
    runs = {}
    for label in ("fit", "multistart", "multistart", "fit"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mttkrp3.launches = to_host.calls = 0
        if label == "fit":
            _, _, _, out = cmtf_aoadmm(spec, data, opts, init_options=init,
                                       seed=0)
            n_it, init_l = out.OuterIterations, 0
            finals = [out.f_tensors]
        else:
            _, out, finals, stops = fit_multistart(
                spec, data, opts, init, MS_STARTS, keys=range(MS_STARTS))
            n_it, init_l = max(stops), inits
        launches, reads = mttkrp3.launches, to_host.calls
        peak = torch.cuda.max_memory_allocated() / 2**20
        ms_it = out.time_total / n_it * 1e3
        runs.setdefault(label, []).append(ms_it)
        print(f"{label}: {n_it} iterations, {ms_it:.3f} ms an iteration "
              f"(wall clock / iterations); to_host.calls {reads} "
              f"({reads / n_it:.2f} an iteration); mttkrp3 launches {launches} "
              f"({(launches - init_l) / n_it:.2f} an iteration, {init_l} for the "
              f"initial objective); peak {peak:.0f} MiB; final f_tensors "
              f"min {np.nanmin(finals):.6e}  [{power}]")
        if not np.all(np.isfinite(finals)) or n_it != MS_ITERS:
            raise RuntimeError(f"{label} on the flagship: {n_it} iterations, "
                               f"finals {finals}")
        if label == "multistart":
            want_l = MS_ITERS * 3 * sum(-(-MS_STARTS * ds.rank // 32) for p, ds in
                                        enumerate(spec.datasets)
                                        if data.objects[p].dim() == 3)
            if launches != want_l + inits:
                raise RuntimeError(f"multistart: {launches} mttkrp3 launches, "
                                   f"not {want_l + inits}")
            if reads > MS_ITERS * (1 + 6 * (opts.MaxInnerIters - 1)):
                raise RuntimeError(f"multistart: {reads} reads in {MS_ITERS} "
                                   f"iterations")
            counts = launches
    print(f"ms an iteration, in turns fit / multistart / multistart / fit: "
          f"{runs['fit'][0]:.3f} / {runs['multistart'][0]:.3f} / "
          f"{runs['multistart'][1]:.3f} / {runs['fit'][1]:.3f}: "
          f"{MS_STARTS} starts at {min(runs['multistart']) / min(runs['fit']):.2f}"
          f"x one start's time  [{power}]")
    states = [init_coupled(spec, data, init, seed=k) for k in range(MS_STARTS)]
    o3 = dataclasses.replace(opts, MaxOuterIters=3)
    print("one start's fit:")
    profile_fit(spec, data, states[0], o3)
    print(f"{MS_STARTS} starts on the start axis:")
    profile_fit(spec, data, None, o3,
                run=lambda: _fit_lanes(spec, data, states, o3))
    del data, states

    # script 15's widths, float64: the card against the CPU, and each start
    # against its own fit on the card
    spec, data_c, opts, init = mw.script15_problem("cpu", torch.float64)
    _, data_g, _, _ = mw.script15_problem(dev, torch.float64)
    opts = dataclasses.replace(opts, MaxOuterIters=MS_S15_ITERS)
    init_np = [state_to_numpy(init_coupled(spec, data_c, init, seed=k))
               for k in range(MS_S15_STARTS)]
    cpu = _fit_lanes(spec, data_c, [state_from_numpy(s, "cpu") for s in init_np],
                     opts)
    mttkrp3.launches = 0
    gpu = _fit_lanes(spec, data_g, [state_from_numpy(s, dev) for s in init_np],
                     opts)
    n_l = mttkrp3.launches
    worst = worst_fit = 0.0
    for s in range(MS_S15_STARTS):
        _, own = fit(spec, data_g, state_from_numpy(init_np[s], dev), opts)
        for label, a, b in (("cpu", gpu.outs[s], cpu.outs[s]),
                            ("own fit", gpu.outs[s], own)):
            if a.OuterIterations != b.OuterIterations \
                    or not np.array_equal(a.innerIters, b.innerIters):
                raise RuntimeError(f"script 15 start {s}: the card's lane and "
                                   f"the {label} ran other iterations")
            for k in ("func_val_conv", "func_coupl_conv", "func_constr_conv"):
                x, y = getattr(a, k), getattr(b, k)
                rel = float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300)))
                if label == "cpu":
                    worst = max(worst, rel)
                else:
                    worst_fit = max(worst_fit, rel)
                np.testing.assert_allclose(x, y, rtol=1e-8, atol=1e-14,
                                           err_msg=f"start {s} {label} {k}")
    print(f"script 15's widths, {MS_S15_STARTS} starts, {MS_S15_ITERS} "
          f"iterations, float64: card lanes against the CPU's max rel diff "
          f"{worst:.3e}, against each start's own card fit {worst_fit:.3e}; "
          f"inner iterations equal; mttkrp3 launches {n_l}")
    if n_l < MS_S15_ITERS * 6:
        raise RuntimeError(f"script 15 on the card launched mttkrp3 {n_l} times")
    done(19, t0)
    return counts


def in_turns(label_fn, power, what):
    """Run label_fn(label) for fit, multistart, multistart, fit (the
    counts set to 0 and the peak memory reset before each) and print the
    ms an iteration in turns; returns {label: [ms, ms]}."""
    import torch
    runs = {}
    for label in ("fit", "multistart", "multistart", "fit"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs.setdefault(label, []).append(label_fn(label))
    print(f"{what}, ms an iteration in turns fit / multistart / multistart / "
          f"fit: {runs['fit'][0]:.3f} / {runs['multistart'][0]:.3f} / "
          f"{runs['multistart'][1]:.3f} / {runs['fit'][1]:.3f}: {MS_STARTS} "
          f"starts at {min(runs['multistart']) / min(runs['fit']):.2f}x one "
          f"start's time  [{power}]")
    return runs


def multistart_rest_phase(dev, power):
    """Phase 20: fit_multistart for the other losses, sparse COO data and
    the pairwise option.  Returns kernel D's and the sparse kernel's
    launches on its paths and kernel D's start-axis times, for the kernels
    line."""
    import warnings
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models import pairwise
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.multistart import _fit_lanes, fit_multistart
    from matlab_code_tpu_torch.models.solver import (
        attach_sparse_plans, cmtf_aoadmm, fit)
    from matlab_code_tpu_torch.ops import losses
    from matlab_code_tpu_torch.ops.loss_cuda import (
        loss_fg_cuda, loss_fg_cuda_starts, loss_fg_mttkrp_cuda,
        loss_fg_mttkrp_cuda_starts)
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.sparse_cuda import mttkrp_sparse_cuda
    from matlab_code_tpu_torch.ops.tensor import mttkrp_sparse
    from matlab_code_tpu_torch.problem import SparseTensor
    from matlab_code_tpu_torch.utils import multistart_workload as mw

    t0 = phase(20, f"multistart: losses, sparse, PP ({MS_STARTS} starts on the "
                   f"KL and sparse workloads against one start's fit; kernel D "
                   f"on the start axis; script 07's widths, {len(mw.S07_KEYS)} "
                   f"starts, card against CPU; the flagship with the pairwise "
                   f"option)")
    S = MS_STARTS
    eps = 1e-10
    out = {}

    # (c) kernel D on the start axis: one launch for S starts against its
    # plain version and against S single-start launches (f and Y bit for
    # bit), timed against the S launches
    flush = l2_flush(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    shape = LOSS_SHAPES[0]
    M64 = 0.05 + 2.95 * torch.rand((S,) + shape, generator=gen, device=dev,
                                   dtype=torch.float64)
    X64 = torch.poisson(M64[0], generator=gen)
    n = X64.numel()
    for dt, rtol_y, rtol_f in zip((torch.float32, torch.float64),
                                  LOSS_RTOL_GH, LOSS_RTOL_F):
        X, M = X64.to(dt), M64.to(dt)
        before = loss_fg_cuda.launches
        f, Y = loss_fg_cuda_starts("KL", X, M, eps)
        n_l = loss_fg_cuda.launches - before
        same_f = same_y = True
        err_y = err_f = 0.0
        for s in range(S):
            f1, Y1 = loss_fg_cuda("KL", X, M[s], eps)
            same_f = same_f and bool(torch.equal(f1, f[s]))
            same_y = same_y and bool(torch.equal(Y1, Y[s]))
            f_r, Y_r = losses.loss_fg_reference("KL", X, M[s], eps)
            err_y = max(err_y, float(((Y[s] - Y_r).abs()
                                      / gh_scale("KL", X, M[s], eps, None)).max()))
            err_f = max(err_f, abs(float(f[s]) - float(f_r)) / abs(float(f_r)))
            del f1, Y1, Y_r
        item = X.element_size()
        t_b, by = bound(item * (n + 2 * S * n), 6 * S * n)
        t_s = time_ms(lambda: loss_fg_cuda_starts("KL", X, M, eps), flush)
        t_1 = time_ms(lambda: [loss_fg_cuda("KL", X, M[s], eps) for s in range(S)],
                      flush)
        print(f"kernel D on the start axis, KL {shape} x {S} starts {dt}: "
              f"{n_l} launch; gh max |kernel-plain| / scale {err_y:.3e} (bound "
              f"{rtol_y:.0e}), sum fh rel diff {err_f:.3e} (bound {rtol_f:.0e}); "
              f"against {S} single launches: f bit for bit {same_f}, Y bit for "
              f"bit {same_y}; {t_s * 1e3:.1f} us against {S} launches "
              f"{t_1 * 1e3:.1f} us; bound {t_b * 1e3:.1f} us ({by})  [{power}]")
        if not (n_l == 1 and same_f and same_y and err_y <= rtol_y
                and err_f <= rtol_f):
            raise RuntimeError(f"kernel D on the start axis disagrees ({dt})")
        if dt == torch.float32:
            out["D"] = {"starts_ms": t_s, "singles_ms": t_1, "starts_bound_ms": t_b}
        del X, M, f, Y
    del M64, X64
    # the fused kernel D on the start axis: S starts sharing the KL
    # workload's X (its shape, rank 8) in one launch, against S single
    # launches (f and G bit for bit, modes 0-2) and against its plain version
    R = 8
    for dt, rtol_g, rtol_f in zip((torch.float32, torch.float64),
                                  FUSED_RTOL_G, LOSS_RTOL_F):
        X, _ = fused_problem(shape, R, dt, dev, 200)
        rng = np.random.default_rng(201)
        Fs = [torch.tensor(rng.uniform(0.1, 1.1, size=(S, d, R)), dtype=dt,
                           device=dev) for d in shape]
        item = X.element_size()
        for mode in range(3):
            before = loss_fg_mttkrp_cuda.launches
            f, G = loss_fg_mttkrp_cuda_starts("KL", X, Fs, mode, eps)
            n_l = loss_fg_mttkrp_cuda.launches - before
            same = True
            err_g = err_f = 0.0
            for s in range(S):
                facs = [F[s] for F in Fs]
                f1, G1 = loss_fg_mttkrp_cuda("KL", X, facs, mode, eps)
                same = same and bool(torch.equal(f1, f[s])
                                     and torch.equal(G1, G[s]))
                if s < 3:    # the plain version of three starts
                    e_f, e_g, _, _ = check_fused("KL", None, X, facs, mode,
                                                 True, eps)
                    err_f, err_g = max(err_f, e_f), max(err_g, e_g)
                del f1, G1
            io = item * (n + S * sum(F.shape[1] for F in Fs) * R
                         + S * shape[mode] * R)
            t_b, by = bound(io, S * n * (4 * R + 5))
            t_s = time_ms(lambda: loss_fg_mttkrp_cuda_starts("KL", X, Fs, mode,
                                                             eps), flush)
            t_1 = time_ms(lambda: [loss_fg_mttkrp_cuda("KL", X,
                                                       [F[s] for F in Fs],
                                                       mode, eps)
                                   for s in range(S)], flush)
            print(f"fused kernel D on the start axis, KL {shape} R {R} x {S} "
                  f"starts {dt} mode {mode}: {n_l} launch; sum fh rel diff "
                  f"{err_f:.3e} (bound {rtol_f:.0e}), G / scale {err_g:.3e} "
                  f"(bound {rtol_g:.0e}) for 3 starts; against {S} single "
                  f"launches: f and G bit for bit {same}; {t_s * 1e3:.1f} us "
                  f"against {S} launches {t_1 * 1e3:.1f} us; bound "
                  f"{t_b * 1e3:.1f} us ({by})  [{power}]")
            if not (n_l == 1 and same and err_g <= rtol_g
                    and err_f <= rtol_f):
                raise RuntimeError(f"fused kernel D on the start axis "
                                   f"disagrees ({dt}, mode {mode})")
            if dt == torch.float32 and mode == 0:
                out["fused"] = {"starts_ms": t_s, "singles_ms": t_1,
                                "starts_bound_ms": t_b}
        del X, Fs, f, G
    del flush

    # (a) the KL workload: S starts against one start's fit, in turns
    spec, data, opts, init = mw.kl_problem(dev, torch.float32)
    opts = dataclasses.replace(opts, MaxOuterIters=MS_KL_ITERS, AbsFuncTol=0.0,
                               OuterRelTol=0.0)

    def kl_run(label):
        loss_fg_cuda.launches = mttkrp3.launches = to_host.calls = 0
        loss_fg_mttkrp_cuda.launches = 0
        with fused_counts() as c:
            if label == "fit":
                _, _, _, o = cmtf_aoadmm(spec, data, opts, init_options=init,
                                         seed=0, validate=False)
                finals = [o.f_tensors]
            else:
                _, o, finals, _ = fit_multistart(spec, data, opts, init, S,
                                                 keys=range(S))
        n_it = o.OuterIterations
        n_d, n_m, reads = loss_fg_cuda.launches, mttkrp3.launches, to_host.calls
        n_f = loss_fg_mttkrp_cuda.launches
        lb = o.lbfgsb_iterations
        print(f"KL workload, {label}: {n_it} iterations, {o.time_total / n_it * 1e3:.3f} "
              f"ms an iteration; host reads {reads / n_it:.2f} an iteration; "
              f"fused kernel D launches {n_f / n_it:.2f} an iteration "
              f"({c['evals'] / n_it:.2f} L-BFGS-B evaluations), old pass "
              f"{n_d}, mttkrp3 {n_m}; peak {torch.cuda.max_memory_allocated() / 2**20:.0f} "
              f"MiB; {'best start' if label != 'fit' else 'the fit'}: L-BFGS-B "
              f"iterations by iteration {lb.sum(axis=0)[1:].tolist()}, f_tensors "
              f"{np.nanmin(finals):.6e}  [{power}]")
        if n_it != MS_KL_ITERS or not np.all(np.isfinite(finals)) \
                or lb.sum() == 0:
            raise RuntimeError(f"KL workload {label}: {n_it} iterations, finals "
                               f"{finals}")
        check_fused_path(f"KL workload, {label}", c, n_f, n_d, n_m, n_it)
        if label == "multistart":
            out["D_launches"] = n_d
            out["fused_launches"] = n_f
        return o.time_total / n_it * 1e3

    in_turns(kl_run, power, "KL workload")
    states = [init_coupled(spec, data, init, seed=k) for k in range(S)]
    o2 = dataclasses.replace(opts, MaxOuterIters=2)
    print("KL workload, one start's fit:")
    profile_fit(spec, data, states[0], o2)
    print(f"KL workload, {S} starts on the start axis:")
    profile_fit(spec, data, None, o2, run=lambda: _fit_lanes(spec, data, states, o2))
    del data, states

    # (b) the sparse workload: one sparse kernel call of S R columns a mode,
    # against S single-start calls, then S starts against one start's fit
    spec, data, opts, init = mw.sparse_problem(dev, torch.float32)
    opts = dataclasses.replace(opts, MaxOuterIters=MS_SPARSE_ITERS,
                               AbsFuncTol=0.0, OuterRelTol=0.0)
    data = attach_sparse_plans(spec, data, opts)
    X = data.objects[0]
    R = spec.datasets[0].rank
    D = spec.mode_sizes[0]
    X64 = SparseTensor(X.indices, X.values.double()).with_plans(spec.mode_sizes, R)
    flush = l2_flush(dev)
    free, total = torch.cuda.mem_get_info()
    for mode in range(3):
        plan = X.plans[mode]
        print(f"sparse mode {mode}: the {plan.variant} kernel, P {plan.lanes}; "
              f"the {S}-start call's partial sums {plan.nchunks} x {S * R} float32 "
              f"= {plan.nchunks * S * R * 4 / 2**20:.1f} MiB of the card's "
              f"{total / 2**30:.1f} GiB ({free / 2**30:.1f} GiB free)")
        for T, dt in ((X, torch.float32), (X64, torch.float64)):
            F = [torch.rand((S, d, R), generator=gen, device=dev, dtype=dt)
                 for d in spec.mode_sizes]
            before = mttkrp_sparse_cuda.launches
            wide = torch.func.vmap(lambda a, b, c: mttkrp_sparse(
                T.indices, T.values, [a, b, c], mode, D, T.plans[mode]))(*F)
            n_l = mttkrp_sparse_cuda.launches - before
            each = torch.stack([mttkrp_sparse_cuda(T.plans[mode], [f[s] for f in F])
                                for s in range(S)])
            rel = float((wide - each).abs().max() / each.abs().max())
            same = bool(torch.equal(wide, each))
            line = (f"  {dt}: one call ({n_l} launch) against {S} single-start "
                    f"calls: max rel diff {rel:.3e}, bit for bit {same}")
            if dt == torch.float32:
                t_w = time_ms(lambda: torch.func.vmap(lambda a, b, c: mttkrp_sparse(
                    T.indices, T.values, [a, b, c], mode, D, T.plans[mode]))(*F),
                    flush)
                t_e = time_ms(lambda: [mttkrp_sparse_cuda(T.plans[mode],
                                                          [f[s] for f in F])
                                       for s in range(S)], flush)
                line += (f"; {t_w * 1e3:.1f} us against {S} calls "
                         f"{t_e * 1e3:.1f} us  [{power}]")
            print(line)
            if n_l != 1 or (dt == torch.float64 and not rel <= 1e-12) \
                    or not rel <= 1e-5:
                raise RuntimeError(f"the sparse kernel's start-axis call "
                                   f"disagrees: mode {mode} {dt}")
            del F, wide, each
    del X64, flush

    def sparse_run(label):
        mttkrp_sparse_cuda.launches = to_host.calls = 0
        if label == "fit":
            _, _, _, o = cmtf_aoadmm(spec, data, opts, init_options=init, seed=0)
            finals = [o.f_tensors]
        else:
            _, o, finals, _ = fit_multistart(spec, data, opts, init, S,
                                             keys=range(S))
        n_it = o.OuterIterations
        n_s, reads = mttkrp_sparse_cuda.launches, to_host.calls
        print(f"sparse workload, {label}: {n_it} iterations, "
              f"{o.time_total / n_it * 1e3:.3f} ms an iteration; host reads "
              f"{reads / n_it:.2f} an iteration; sparse kernel launches {n_s} "
              f"({(n_s - 1) / n_it:.2f} an iteration, 1 for the initial "
              f"objective); peak {torch.cuda.max_memory_allocated() / 2**20:.0f} "
              f"MiB; f_tensors {np.nanmin(finals):.6e}  [{power}]")
        if n_it != MS_SPARSE_ITERS or not np.all(np.isfinite(finals)) \
                or n_s != 3 * n_it + 1:
            raise RuntimeError(f"sparse workload {label}: {n_it} iterations, "
                               f"{n_s} sparse launches, finals {finals}")
        if label == "multistart":
            out["sparse_launches"] = n_s
        return o.time_total / n_it * 1e3

    in_turns(sparse_run, power, "sparse workload")
    del data, X

    # (d) script 07's widths, float64: the card's starts against the CPU's
    # and against each start's own card fit
    spec7, data_c, o7, init7 = mw.script07_problem("cpu", torch.float64,
                                                   MS_S07_ITERS)
    _, data_g, _, _ = mw.script07_problem(dev, torch.float64, MS_S07_ITERS)
    init_np = [state_to_numpy(init_coupled(spec7, data_c, init7, seed=k))
               for k in mw.S07_KEYS]
    cpu = _fit_lanes(spec7, data_c, [state_from_numpy(s, "cpu") for s in init_np],
                     o7)
    loss_fg_cuda.launches = loss_fg_mttkrp_cuda.launches = 0
    gpu = _fit_lanes(spec7, data_g, [state_from_numpy(s, dev) for s in init_np], o7)
    n_d, n_f = loss_fg_cuda.launches, loss_fg_mttkrp_cuda.launches
    worst = {"cpu": 0.0, "own fit": 0.0}
    for s in range(len(init_np)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the data are not counts
            _, own = fit(spec7, data_g, state_from_numpy(init_np[s], dev), o7)
        for label, a, b in (("cpu", gpu.outs[s], cpu.outs[s]),
                            ("own fit", gpu.outs[s], own)):
            if a.OuterIterations != b.OuterIterations \
                    or not np.array_equal(a.innerIters, b.innerIters) \
                    or not np.array_equal(a.lbfgsb_iterations, b.lbfgsb_iterations):
                raise RuntimeError(f"script 07 start {s}: the card's lane and "
                                   f"the {label} ran other iterations")
            for k in ("func_val_conv", "func_coupl_conv"):
                x, y = getattr(a, k), getattr(b, k)
                worst[label] = max(worst[label], float(np.max(
                    np.abs(x - y) / np.maximum(np.abs(y), 1e-300))))
    print(f"script 07's widths, {len(init_np)} starts (init seeds {mw.S07_KEYS}), "
          f"{MS_S07_ITERS} iterations, float64: the card's lanes against the "
          f"CPU's max rel diff {worst['cpu']:.3e}, against each start's own card "
          f"fit {worst['own fit']:.3e} (bound 1e-12); inner and L-BFGS-B "
          f"iterations equal; launches for all starts: old pass {n_d} (the "
          f"matrix), fused kernel D {n_f} (the tensor); L-BFGS-B iterations "
          f"{[int(o.lbfgsb_iterations.sum()) for o in gpu.outs]}")
    if n_d == 0 or n_f == 0 or not max(worst.values()) <= 1e-12:
        raise RuntimeError(f"script 07 on the start axis: {worst}, D {n_d}, "
                           f"fused {n_f}")

    # (e) the flagship with cp_pairwise_perturbation: the exact MTTKRPs, as
    # the JAX function runs them, so the finals equal the run without it
    spec, data, opts, init = mw.flagship_problem(dev, torch.float32, MS_PP_ITERS)
    opts = dataclasses.replace(opts, AbsFuncTol=0.0, OuterRelTol=0.0)
    finals = {}
    for pp in (False, True):
        pairwise.reset_counts()
        _, _, finals[pp], _ = fit_multistart(
            spec, data, dataclasses.replace(opts, cp_pairwise_perturbation=pp),
            init, MS_PP_STARTS, keys=range(MS_PP_STARTS))
        first, active, rebuilds = pp_counts()
        if active or rebuilds:
            raise RuntimeError("fit_multistart ran the pairwise gate")
    print(f"flagship, {MS_PP_STARTS} starts, {MS_PP_ITERS} iterations: finals with "
          f"cp_pairwise_perturbation {finals[True].tolist()}, without "
          f"{finals[False].tolist()}; equal {np.array_equal(finals[True], finals[False])}")
    if not np.array_equal(finals[True], finals[False]):
        raise RuntimeError("fit_multistart with the pairwise option moved")
    del data
    done(20, t0)
    return out


def _replay_legs(names, device, iters, **overrides):
    """Phase 21 (a)'s legs on one device: each replay of `names` (data and
    init drawn by the port on the MATLAB stream) in float64 for `iters`
    outer iterations, AbsFuncTol = OuterRelTol = 0.  Returns {name:
    (func_val_conv, innerIters, the final factors as numpy arrays,
    seconds)}.  The CPU legs run in a worker process beside the card's."""
    sys.path.insert(0, REPO)
    import torch
    from matlab_code_tpu_torch.examples import run_all
    if device == "cpu":
        torch.set_num_threads(1)     # the card legs' host loop keeps a core
    legs = {}
    for name in names:
        t = time.perf_counter()
        res = run_all.module(name).run_reference(
            verbose=False, device=device, dtype=torch.float64, AbsFuncTol=0.0,
            OuterRelTol=0.0, MaxOuterIters=iters, **overrides)
        legs[name] = (res["out"].func_val_conv, res["out"].innerIters,
                      [f.detach().cpu().numpy() for f in res["state"].fac],
                      time.perf_counter() - t)
    return legs


def _hold_replay(card, cpu):
    """A replay's card leg against its CPU leg (_replay_legs): func_val_conv
    at rtol 1e-8, each final factor within 1e-8 of its largest entry,
    innerIters equal.  Returns (ok, the worst relative gaps, inner equal)."""
    (a, inner_g, fac_g, _), (b, inner_c, fac_c, _) = card, cpu
    f_rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    fac_rel = max(float(np.abs(g - c).max() / np.abs(c).max())
                  for g, c in zip(fac_g, fac_c))
    same_inner = bool(np.array_equal(inner_g, inner_c))
    ok = (f_rel <= 1e-8 and fac_rel <= 1e-8 and same_inner
          and len(a) == len(b))
    return ok, f_rel, fac_rel, same_inner


def _example_caps(name):
    """Phase 21 (b)'s MaxOuterIters cap of a script."""
    return {"script09": EXAMPLE_S09_ITERS,
            "script15": EXAMPLE_S15_ITERS}.get(name[:8], EXAMPLE_ITERS)


def _example_run(name, dev):
    """Phase 21 (b)'s run of one configuration, in a worker process that
    shares the card: build(small=False) at the script's widths in float32,
    MaxOuterIters capped (_example_caps), each kernel's launches counted
    from zero just before the script's data, init and fit.  For script 09
    also kernel A's launches in its init alone (the same init again on the
    fit's data), so the launches of its fit are known.  Returns what the
    phase prints and checks."""
    sys.path.insert(0, REPO)
    import torch
    from matlab_code_tpu_torch.examples import run_all
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.ops.loss_cuda import (
        loss_fg_cuda, loss_fg_mttkrp_cuda)
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.prox_cuda import (
        project_isotonic_cols, prox_tv_cols, t_smooth_cols)
    from matlab_code_tpu_torch.ops.sparse_cuda import mttkrp_sparse_cuda
    from matlab_code_tpu_torch.options import InitOptions

    torch.set_num_threads(2)
    counters = {"mttkrp3": mttkrp3, "A": project_isotonic_cols,
                "B": prox_tv_cols, "C": t_smooth_cols, "D": loss_fg_cuda,
                "fused": loss_fg_mttkrp_cuda, "sparse": mttkrp_sparse_cuda}
    for fn in counters.values():
        fn.launches = 0
    tb = time.perf_counter()
    res = run_all.run_script(name, small=False, device=dev,
                             dtype=torch.float32, max_iters=_example_caps(name),
                             verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tb
    n = {k: fn.launches for k, fn in counters.items()}
    out = res["out"]
    cfg = run_all.module(name).build()
    cp3 = [ds.loss for ds in cfg["spec"].datasets
           if ds.model == "CP" and len(ds.modes) == 3]
    row = dict(
        cp3="Frobenius" in cp3, cp3_loss=any(x != "Frobenius" for x in cp3),
        iters=out.OuterIterations, exit=out.exit_flag,
        dts=np.diff(out.time_at_it) * 1e3, secs=secs, launches=n,
        report=res["report"], finite=bool(np.all(np.isfinite(np.stack(
            [out.func_val_conv, out.func_coupl_conv, out.func_constr_conv,
             out.func_PAR2_coupl])))),
        iter_start=cfg["opts"].iter_start_PAR2Bkconstraint)
    if name.startswith("script09"):
        project_isotonic_cols.launches = 0
        init_coupled(cfg["spec"], res["data"], InitOptions(
            distr=tuple(cfg["distr"]), normalize=True,
            lambdas_init=tuple(tuple(l) for l in cfg["lambdas"])),
            seed=cfg["key"])
        row["A_init"] = project_isotonic_cols.launches
    return row


def examples_phase(dev, power):
    """Phase 21: the examples on the card (matlab_code_tpu_torch/examples/).
    (a) the 13 reference-seeded replays, data and init drawn by the port's
    utils/matlab_rng.py, EXAMPLE_REPLAY_ITERS outer iterations on the card
    and on the CPU in float64 (AbsFuncTol = OuterRelTol = 0; the CPU legs
    in a worker process while the card legs run), held to each other
    (_hold_replay); a PARAFAC2 replay that misses runs its card leg
    again with par2_polar='svd', the CPU's resolution of 'auto'; (b) the
    16 configurations of build(small=False) at the scripts' widths in
    float32 (_example_run), EXAMPLE_WORKERS at a time in worker processes
    that share the card with each other and with (a): each with finite
    streams and the kernels it should launch, script 09 past its Bk
    constraint's start with kernel A in each constrained iteration.
    Fails past EXAMPLE_PHASE_S seconds.  Returns the launches of each
    kernel over (b), for the kernels line."""
    from matlab_code_tpu_torch.examples import run_all

    t_phase = time.perf_counter()
    t0 = phase(21, f"the examples: {len(run_all.REPLAYS)} replays card vs CPU "
                   f"in float64 ({EXAMPLE_REPLAY_ITERS} iterations), "
                   f"{len(run_all.SCRIPTS)} configurations at full width in "
                   f"float32 (at most {EXAMPLE_ITERS} iterations, script 09 "
                   f"{EXAMPLE_S09_ITERS}), {EXAMPLE_WORKERS} at a time")
    spawn = multiprocessing.get_context("spawn")
    # the costliest scripts first, so the workers end together
    order = sorted(run_all.SCRIPTS,
                   key=lambda n: n[:8] not in ("script09", "script07"))
    with ProcessPoolExecutor(1, mp_context=spawn) as cpu_pool, \
            ProcessPoolExecutor(EXAMPLE_WORKERS, mp_context=spawn) as pool:
        runs = {name: pool.submit(_example_run, name, dev) for name in order}
        fut = cpu_pool.submit(_replay_legs, run_all.REPLAYS, "cpu",
                              EXAMPLE_REPLAY_ITERS)
        card = _replay_legs(run_all.REPLAYS, dev, EXAMPLE_REPLAY_ITERS)
        cpu = fut.result()
        for name in run_all.REPLAYS:
            ok, f_rel, fac_rel, same_inner = _hold_replay(card[name],
                                                          cpu[name])
            leg = "par2_polar 'auto' ('ns' on the card)"
            par2 = any(ds.model == "PAR2" for ds in
                       run_all.module(name).build()["spec"].datasets)
            if not ok and par2:
                print(f"  {name}: 'auto' missed (f {f_rel:.3e}, factors "
                      f"{fac_rel:.3e}, inner equal {same_inner}); card leg "
                      f"again with par2_polar='svd'")
                card[name] = _replay_legs([name], dev, EXAMPLE_REPLAY_ITERS,
                                          par2_polar="svd")[name]
                ok, f_rel, fac_rel, same_inner = _hold_replay(card[name],
                                                              cpu[name])
                leg = "par2_polar 'svd'"
            print(f"  replay {name}: max rel diff card/CPU f_tensors "
                  f"{f_rel:.3e}, factors {fac_rel:.3e} (bounds 1e-8), "
                  f"innerIters equal {same_inner}; card leg {leg} "
                  f"{card[name][3]:.2f} s; CPU leg {cpu[name][3]:.2f} s (a "
                  f"worker process, beside the card's)")
            if not ok:
                raise RuntimeError(f"replay {name}: the card and the CPU "
                                   f"disagree")
        print(f"  replays done in {time.perf_counter() - t0:.1f} s")
        rows = {name: f.result() for name, f in runs.items()}

    expect = {"script07": "D", "script09": "A", "script10": "B",
              "script11": "C"}
    total = {}
    for name in run_all.SCRIPTS:
        r = rows[name]
        n, dts = r["launches"], r["dts"]
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        report = "; ".join(
            f"{p}: Fit {v[0]:.3f}% FMS " + "/".join(f"{x:.4f}" for x in v[1:])
            for p, v in r["report"].items())
        print(f"  {name}: {r['iters']} iterations, exit {r['exit']}, median "
              f"{np.median(dts):.3f} ms an iteration (p90 "
              f"{np.percentile(dts, 90):.3f}), {r['secs']:.1f} s with data "
              f"and init; {report}; launches "
              f"{ {k: v for k, v in n.items() if v} }  [{power}; "
              f"{EXAMPLE_WORKERS} fits share the card]")
        if not r["finite"]:
            raise RuntimeError(f"{name}: non-finite objective stream")
        # a 3-way CP dataset: mttkrp3 for a Frobenius one, the fused
        # kernel D for a KL, IS or beta one
        need = ([expect[name[:8]]] if name[:8] in expect else []) + \
            (["mttkrp3"] if r["cp3"] else []) + \
            (["fused"] if r["cp3_loss"] else [])
        missing = [k for k in need if n[k] == 0]
        if missing:
            raise RuntimeError(f"{name}: no launch of {missing}: a path fell "
                               f"back to a plain version")
        if "A_init" in r:
            # iterations iter_start .. iters run the Bk constraint, each at
            # least one unimodal prox (kernel A) a step
            start = r["iter_start"]
            n_con = r["iters"] - start + 1
            n_fit = n["A"] - r["A_init"]
            print(f"    Bk constraint from iteration {start}: iterations "
                  f"1-{start - 1} median {np.median(dts[:start - 1]):.3f} ms, "
                  f"{start}-{r['iters']} ({n_con} constrained) median "
                  f"{np.median(dts[start - 1:]):.3f} ms (p90 "
                  f"{np.percentile(dts[start - 1:], 90):.3f}); kernel A "
                  f"{r['A_init']} launches in the init, {n_fit} in the fit "
                  f"({n_fit / max(n_con, 1):.2f} a constrained iteration)")
            if n_con < 1 or n_fit < n_con:
                raise RuntimeError(f"{name}: kernel A launched {n_fit} times "
                                   f"in {n_con} constrained iterations")
    print(f"  launches over the {len(run_all.SCRIPTS)} configurations: {total}")
    secs = time.perf_counter() - t_phase
    print(f"phase 21 took {secs:.1f} s (limit {EXAMPLE_PHASE_S} s)")
    if secs > EXAMPLE_PHASE_S:
        raise RuntimeError(f"phase 21 took {secs:.1f} s, past its "
                           f"{EXAMPLE_PHASE_S} s")
    done(21, t0)
    return total


def bf16_phase(dev, power):
    """Phase 22: what torch's float32 matmul precisions give on the card: a
    4096^2 float32 GEMM under 'highest', 'high' and 'medium' against its
    float64 product (Frobenius-relative error, CUDA-event time), beside the
    error of the product of the inputs rounded to bfloat16 and to TF32 (the
    levels each kind of product reaches), and the decision that
    options.py takes for matmul_precision='bfloat16' on the card."""
    import torch
    from matlab_code_tpu_torch import options
    t0 = phase(22, "matmul_precision 'bfloat16': float32 GEMM precisions vs float64")
    n = BF16_N
    gen = torch.Generator(device=dev).manual_seed(22)
    A = torch.randn((n, n), generator=gen, device=dev)
    B = torch.randn((n, n), generator=gen, device=dev)
    C64 = A.double() @ B.double()
    ref = C64.norm()

    def tf32(x):      # round to nearest, 10 stored mantissa bits
        i = x.view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)

    levels = {
        "inputs rounded to bfloat16": A.bfloat16().double() @ B.bfloat16().double(),
        "inputs rounded to TF32": tf32(A).double() @ tf32(B).double()}
    for label, C in levels.items():
        levels[label] = float((C - C64).norm() / ref)
        print(f"  {label}, products in float64: rel error {levels[label]:.3e}")
    flush = l2_flush(dev)
    saved = torch.get_float32_matmul_precision()
    errs = {}
    try:
        for prec in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(prec)
            C = A @ B
            errs[prec] = float((C.double() - C64).norm() / ref)
            t = time_ms(lambda: A @ B, flush)
            print(f"  float32_matmul_precision {prec!r} (allow_tf32 "
                  f"{torch.backends.cuda.matmul.allow_tf32}): rel error "
                  f"{errs[prec]:.3e}, {t:.3f} ms ({2 * n ** 3 / t / 1e9:.1f} "
                  f"TFLOP/s)  [{power}]")
    finally:
        torch.set_float32_matmul_precision(saved)
    bf16_level = errs["medium"] >= 0.5 * levels["inputs rounded to bfloat16"]
    print(f"  'medium' gives {'bfloat16' if bf16_level else 'TF32'}-level "
          f"products ({errs['medium']:.3e} against {levels['inputs rounded to bfloat16']:.3e}"
          f" for bfloat16 inputs and {levels['inputs rounded to TF32']:.3e} for "
          f"TF32 inputs)")
    try:
        options.apply_matmul_precision(
            options.AlgOptions(matmul_precision="bfloat16"), dev)
        decision = "mapped"
    except NotImplementedError as e:
        decision = f"raises on the card: {e}"
    finally:
        options.apply_matmul_precision(options.AlgOptions(), dev)
    print(f"  options.py, matmul_precision='bfloat16' on the card: {decision}")
    if (decision == "mapped") != bf16_level:
        raise RuntimeError("options.py's bfloat16 decision does not match "
                           "what 'medium' gives on this card")
    del A, B, C64, flush
    done(22, t0)


def _mesh_problem(job, dev):
    """(kind, spec, data, options, init) of one of phase 23's or 24's runs,
    built from its seed on `dev`: job is 'workload/dtype' ('flagship-ring'
    the flagship with mesh_pipelined_collectives; 'par2' the PAR2 K=512
    workload, 'par2-<config>' a configuration of the PARAFAC2 surface).
    init: the init options of cmtf_aoadmm(seed=1), or the init state of the
    KL workload."""
    import torch
    from matlab_code_tpu_torch.utils import flagship
    from matlab_code_tpu_torch.utils import kl_workload as klw
    from matlab_code_tpu_torch.utils import par2_surface, par2_workload
    from matlab_code_tpu_torch.utils import sparse_workload as sw
    work, dt = job.split("/")
    dt = getattr(torch, dt)
    stop = dict(AbsFuncTol=0.0, OuterRelTol=0.0)
    if work.startswith("par2"):
        n = MESH_ITERS if dt == torch.float32 else MESH_PAR2_ITERS
        if work == "par2":
            spec, data = par2_workload.build_problem(dev, dt)
            return (work, spec, data, par2_workload.par2_options(n, **stop),
                    par2_workload.par2_init_options())
        config = work.split("-", 1)[1]
        spec, data = par2_surface.build_problem(config, dev, dt)
        return (work, spec, data,
                par2_surface.surface_options(config, n, **stop),
                par2_surface.surface_init_options(config))
    if work.startswith("flagship") or work == "multistart":
        spec, data = flagship.build_problem(dev, dt)
        opts = flagship.flagship_options(
            MESH_ITERS, mesh_pipelined_collectives=work == "flagship-ring",
            **stop)
        return work, spec, data, opts, flagship.flagship_init_options()
    if work == "sparse":
        spec, data = sw.build_problem(device=dev, dtype=dt)
        return (work, spec, data, sw.sparse_options(MESH_ITERS, **stop),
                sw.sparse_init_options())
    spec, data, state0, _ = klw.build_problem(dev, dt)
    return work, spec, data, klw.kl_options(MESH_KL_ITERS, **stop), state0


def _mesh_fit(job, dev, mesh=None, ulp=False, par2=None):
    """Run one of phase 23's or 24's jobs (_mesh_problem), over `mesh` or
    plain, and return what the phase prints and holds, as numpy: the
    streams, the factors, the median ms an iteration, the kernels' launches
    in the fit alone (each count set to 0 after the init and just before
    the fit), and over a mesh the collectives' counts and host-staging
    seconds, whether every rank holds the same state bits, and the bytes
    the ring's chunk copies take.  ulp: the data times 1 + 2^-52, the
    yardstick of the KL run's sensitivity.  par2: the data laid out by hand
    with sharding.data_shardings(par2=par2) before the fit (None: fit lays
    them out)."""
    import torch
    from matlab_code_tpu_torch.models.init import init_coupled
    from matlab_code_tpu_torch.models.multistart import fit_multistart
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops.loss_cuda import (
        loss_fg_cuda, loss_fg_mttkrp_cuda)
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    from matlab_code_tpu_torch.ops.prox_cuda import (
        project_isotonic_cols, prox_tv_cols, t_smooth_cols)
    from matlab_code_tpu_torch.ops.sparse_cuda import mttkrp_sparse_cuda
    from matlab_code_tpu_torch.parallel import distributed, sharding
    from matlab_code_tpu_torch.parallel.shard_mttkrp import pad_sparse_nnz
    work, spec, data, opts, init = _mesh_problem(job, dev)
    row = {"chunk_bytes": 0}
    if ulp:
        data = dataclasses.replace(data, objects=tuple(
            X * (1 + 2.0 ** -52) for X in data.objects))
    if mesh is not None and work == "sparse":
        data = dataclasses.replace(data, objects=(pad_sparse_nnz(
            data.objects[0], mesh.size),))
    if work not in ("multistart", "kl"):
        # drawn on the full data before the counts are set to 0 (the
        # PARAFAC2 init launches kernel A or B once a slice)
        init = init_coupled(spec, data, init, seed=1)
    if mesh is not None and opts.mesh_pipelined_collectives:
        # the ring's chunk copies, cut at each form's first call
        laid, st = sharding.lay_out(spec, data, init, mesh)
        row["chunk_bytes"] = _ring_chunk_bytes(spec, laid, st, mesh)
        del laid, st
    if mesh is not None and par2 is not None:
        data = sharding.device_put(data, sharding.data_shardings(
            spec, data, mesh, par2=par2)[0])
    counters = {"mttkrp3": mttkrp3, "sparse": mttkrp_sparse_cuda,
                "D": loss_fg_cuda, "fused": loss_fg_mttkrp_cuda,
                "A": project_isotonic_cols, "B": prox_tv_cols,
                "C": t_smooth_cols}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    if mesh is not None:
        mesh.reset_stats()
    t = time.perf_counter()
    if work == "multistart":
        state, out, finals, stops = fit_multistart(
            spec, data, opts, init, MESH_STARTS, keys=range(MESH_STARTS),
            mesh=mesh)
        row.update(finals=finals, stops=list(stops))
    elif work == "kl":
        state, out = fit(spec, data, init, opts, mesh=mesh, validate=not ulp)
    else:
        _, state, _, out = cmtf_aoadmm(spec, data, opts, init=init,
                                       mesh=mesh)
    torch.cuda.synchronize()
    row.update(secs=time.perf_counter() - t,
               launches={k: fn.launches for k, fn in counters.items()},
               f=np.asarray(out.func_val_conv),
               f_par2=np.asarray(out.func_PAR2_coupl),
               fac=[f.detach().cpu().numpy() for f in state.fac],
               ms=float(np.median(np.diff(out.time_at_it)) * 1e3),
               iters=out.OuterIterations)
    if mesh is not None:
        row.update(counts=dict(mesh.counts), stage=dict(mesh.stage_seconds),
                   agree=distributed.replicas_agree(state, mesh))
    return row


def _ring_chunk_bytes(spec, data, state, mesh):
    """The bytes the ring forms' chunk copies take on this rank: each
    form called once on its dataset's block."""
    from matlab_code_tpu_torch.parallel.shard_mttkrp import (
        build_sharded_mttkrps)
    total = 0
    for (p, _), f in build_sharded_mttkrps(spec, data, mesh,
                                           pipelined=True).items():
        if hasattr(f, "chunk_bytes"):
            f(data.objects[p], [state.fac[m] for m in spec.datasets[p].modes])
            total += f.chunk_bytes
    return total


def _kl_first_evals(job, dev, mesh=None):
    """Each KL mode's first L-BFGS-B evaluation (lbfgs_bridge's vag at its
    start point: f and the gradient) at the KL workload's init state, with
    rho MESH_KL_EVAL_RHO, over `mesh` (data laid out, kernel D on the
    block, psum of f, the gh MTTKRP through the sharded form) or plain.
    The L-BFGS-B is stopped after that evaluation.  Returns {"evals":
    [(f, g) by mode], "launches": kernel D's launches}."""
    import types
    import torch
    from matlab_code_tpu_torch.models import lbfgs_bridge
    from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_cuda
    from matlab_code_tpu_torch.parallel import sharding
    _, spec, data, opts, state = _mesh_problem(job.replace("kl-eval", "kl"),
                                               dev)
    if mesh is not None:
        data, state = sharding.lay_out(spec, data, state, mesh)
    evals = []

    def first_eval(vag, x0, *args, **kwargs):
        f, g = vag(x0)
        evals.append((float(f), g.detach().cpu().numpy()))
        return types.SimpleNamespace(x=x0, iterations=0)

    real = lbfgs_bridge.lbfgsb
    lbfgs_bridge.lbfgsb = first_eval
    torch.cuda.synchronize()
    loss_fg_cuda.launches = 0
    try:
        for m in spec.datasets[0].modes:
            lbfgs_bridge.make_lbfgs_step(spec, 0, m, opts)(
                state, data, True, -1, MESH_KL_EVAL_RHO)
    finally:
        lbfgs_bridge.lbfgsb = real
    torch.cuda.synchronize()
    return {"evals": evals, "launches": loss_fg_cuda.launches}


def _mesh_rank(rank, world, url, backend, jobs):
    """Phase 23's or 24's rank `rank` of `world`, a spawned worker
    process: joins the group (`backend` over `url`), runs `jobs` over the
    mesh (_mesh_fit; a job '<job>+<par2>' laid out by hand with
    data_shardings(par2=...)) and, where `plain`, each job again without the mesh after
    it.  Returns {job: row} ({job: (mesh row, plain row)} where plain)."""
    sys.path.insert(0, REPO)
    import torch
    from matlab_code_tpu_torch.parallel import distributed
    assert "jax" not in sys.modules
    torch.set_num_threads(2)
    distributed.initialize(url, world, rank, backend=backend)
    try:
        mesh = distributed.make_global_mesh()
        dev = mesh.device
        rows = {}
        for job, plain in jobs:
            if job.startswith("kl-eval"):
                rows[job] = _kl_first_evals(job, dev, mesh)
                continue
            base, _, par2 = job.partition("+")
            row = _mesh_fit(base, dev, mesh, par2=par2 or None)
            rows[job] = (row, _mesh_fit(base, dev)) if plain else row
        return rows
    finally:
        distributed.shutdown()


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mesh_row_line(row):
    stage = {k: round(v * 1e3, 3) for k, v in row["stage"].items() if v}
    return (f"launches {row['launches']}; collectives {row['counts']}; "
            f"host staging ms {stage or 0}")


def mesh_phase(dev, power):
    """Phase 23: fit(mesh=), cmtf_aoadmm(mesh=) and fit_multistart(mesh=)
    on the card (matlab_code_tpu_torch/parallel/), in spawned worker
    processes.  (a) one rank over a real NCCL communicator (world size 1):
    the full-width flagship and the sparse workload through
    cmtf_aoadmm(mesh=) for MESH_ITERS iterations in float32 against the
    plain card fit in the same process (the bits must be equal: with one
    rank every collective is the identity; ms an iteration); (b) two ranks sharing the card over gloo (NCCL
    refuses two ranks on one card): the full-width flagship (bulk and ring
    collectives) and the sparse workload (nnz padded to even), float64,
    MESH_ITERS iterations, each rank running mttkrp3 or the sparse kernel
    on its half, against the plain card fit at MESH_RTOL; the KL
    workload's first L-BFGS-B evaluation of each mode at the init state
    (kernel D on each rank's block, _kl_first_evals) against the plain one
    at MESH_KL_EVAL_RTOL, and its fit for MESH_KL_ITERS iterations within
    MESH_KL_SLACK times the gap of the plain card fit on the data times
    1 + 2^-52, never past MESH_KL_CAP; fit_multistart of the flagship with MESH_STARTS starts
    split 10 and 10 against the unsharded port (finals at MESH_RTOL, stop
    iterations equal).  Every run holds every rank's state bit-equal
    (distributed.replicas_agree), and launches its kernels on every rank
    (each count set to 0 just before the run).  Fails past MESH_PHASE_S
    seconds.  Returns the launches by kernel over the mesh runs, for the
    kernels line."""
    t_phase = time.perf_counter()
    t0 = phase(23, f"mesh on the card: (a) one NCCL rank, (b) two gloo ranks "
                   f"sharing the card; {MESH_ITERS} iterations")
    spawn = multiprocessing.get_context("spawn")
    total = {"mttkrp3": 0, "sparse": 0, "D": 0, "fused": 0, "A": 0, "B": 0,
             "C": 0}

    def count(row, need):
        for k, v in row["launches"].items():
            total[k] += v
        missing = [k for k in need if row["launches"][k] == 0]
        if missing:
            raise RuntimeError(f"phase 23: no launch of {missing} over the "
                               "mesh: a path fell back to a plain version")
        if not row["agree"]:
            raise RuntimeError("phase 23: the ranks' states differ")
        if not np.all(np.isfinite(row["f"])):
            raise RuntimeError("phase 23: non-finite objective stream")

    need = {"flagship": ["mttkrp3"], "flagship-ring": ["mttkrp3"],
            "sparse": ["sparse"], "kl": ["mttkrp3", "D"],
            "multistart": ["mttkrp3"]}
    # (a) one rank over NCCL
    jobs_a = [("flagship/float32", True), ("sparse/float32", True)]
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        rows_a = pool.submit(_mesh_rank, 0, 1, f"tcp://localhost:{_free_port()}",
                             "nccl", jobs_a).result()
    secs_a = time.perf_counter() - t_phase
    for job, _ in jobs_a:
        m, p = rows_a[job]
        count(m, need[job.split("/")[0]])
        same = all(np.array_equal(a, b) for a, b in zip(m["fac"], p["fac"]))
        same_f = np.array_equal(m["f"], p["f"])
        gap = float(np.max(np.abs(m["f"] - p["f"]) / np.abs(p["f"])))
        print(f"  (a) NCCL, 1 rank, {job}: ms an iteration {m['ms']:.3f} over "
              f"the mesh, {p['ms']:.3f} plain; the plain card fit's factor "
              f"bits: {same}, its f_tensors stream's bits: {same_f} (rel gap "
              f"{gap:.3e}); {_mesh_row_line(m)}  [{power}]")
        # one rank: every psum and all_gather is the identity, so the mesh
        # fit runs the plain fit's operations on the same data
        if not (same and same_f):
            raise RuntimeError(f"phase 23 {job}: the one-rank NCCL fit's bits "
                               "differ from the plain card fit's")

    # (b) two ranks over gloo, sharing the card; the plain card fits here
    jobs_b = ["flagship/float64", "flagship-ring/float64", "sparse/float64",
              "kl-eval/float64", "kl/float64", "multistart/float64"]
    plain = {"kl-eval/float64": _kl_first_evals("kl-eval/float64", dev)}
    for job in ("flagship/float64", "sparse/float64", "kl/float64",
                "multistart/float64"):
        plain[job] = _mesh_fit(job, dev)
    plain["flagship-ring/float64"] = plain["flagship/float64"]
    ulp = _mesh_fit("kl/float64", dev, ulp=True)
    p = plain["kl/float64"]
    kl_gap = (float(np.max(np.abs(ulp["f"] - p["f"]) / np.abs(p["f"]))),
              max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(ulp["fac"], p["fac"])))
    print(f"  the plain card fit of the KL workload on its data times 1 + 2^-52:"
          f" f_tensors rel gap {kl_gap[0]:.3e}, factors {kl_gap[1]:.3e} of "
          f"their largest entry (its L-BFGS-B's sensitivity)  [{power}]")
    secs_plain = time.perf_counter() - t_phase - secs_a
    url = f"tcp://localhost:{_free_port()}"
    with ProcessPoolExecutor(2, mp_context=spawn) as pool:
        futs = [pool.submit(_mesh_rank, r, 2, url, "gloo",
                            [(j, False) for j in jobs_b]) for r in range(2)]
        ranks = [f.result() for f in futs]
    for job in jobs_b:
        work = job.split("/")[0]
        p = plain[job]
        if work == "kl-eval":
            for r, rows in enumerate(ranks):
                m = rows[job]
                gaps = [(abs(fm - fp) / abs(fp),
                         float(np.abs(gm - gp).max() / np.abs(gp).max()))
                        for (fm, gm), (fp, gp) in zip(m["evals"], p["evals"])]
                total["D"] += m["launches"]
                print(f"  (b) gloo, rank {r} of 2, {job}: each mode's first "
                      f"L-BFGS-B evaluation at the init state, (f rel gap, "
                      f"gradient gap of its largest entry) "
                      f"{[(float(f'{a:.3e}'), float(f'{b:.3e}')) for a, b in gaps]}"
                      f" (bound {MESH_KL_EVAL_RTOL:.0e}); kernel D launches "
                      f"{m['launches']}  [{power}]")
                if (len(gaps) != len(p["evals"]) or m["launches"] == 0
                        or max(max(g) for g in gaps) > MESH_KL_EVAL_RTOL):
                    raise RuntimeError(f"phase 23 {job}: rank {r}'s "
                                       "evaluation misses the plain one")
            for a, b in zip(ranks[0][job]["evals"], ranks[1][job]["evals"]):
                if a[0] != b[0] or not np.array_equal(a[1], b[1]):
                    raise RuntimeError(f"phase 23 {job}: the ranks' "
                                       "evaluations differ")
            continue
        rtol, ftol = MESH_RTOL, 1e-8
        if work == "kl":
            rtol = max(rtol, min(MESH_KL_SLACK * kl_gap[0], MESH_KL_CAP[0]))
            ftol = max(ftol, min(MESH_KL_SLACK * kl_gap[1], MESH_KL_CAP[1]))
        for r, rows in enumerate(ranks):
            m = rows[job]
            count(m, need[work])
            gap = float(np.max(np.abs(m["f"] - p["f"]) / np.abs(p["f"])))
            fgap = max(float(np.abs(a - b).max() / np.abs(b).max())
                       for a, b in zip(m["fac"], p["fac"]))
            extra = ""
            if work == "multistart":
                extra = (f"; finals rel gap "
                         f"{float(np.max(np.abs(m['finals'] - p['finals']) / np.abs(p['finals']))):.3e}, "
                         f"stop iterations equal {m['stops'] == p['stops']}")
                if m["stops"] != p["stops"] or not np.allclose(
                        m["finals"], p["finals"], rtol=rtol, atol=0):
                    raise RuntimeError(f"phase 23 {job}: the starts moved")
            if m["chunk_bytes"]:
                extra += f"; ring chunk copies {m['chunk_bytes'] / 2**20:.1f} MiB"
            print(f"  (b) gloo, rank {r} of 2, {job}: ms an iteration "
                  f"{m['ms']:.3f} over the mesh, {p['ms']:.3f} plain (one "
                  f"process alone); f_tensors rel gap {gap:.3e}, factors "
                  f"{fgap:.3e} of their largest entry (bounds {rtol:.3e}, "
                  f"{ftol:.3e}); "
                  f"{_mesh_row_line(m)}{extra}  [{power}]")
            if gap > rtol or fgap > ftol:
                raise RuntimeError(f"phase 23 {job}: rank {r} misses the "
                                   f"plain card fit ({gap:.3e}, {fgap:.3e})")
        for a, b in zip(ranks[0][job]["fac"], ranks[1][job]["fac"]):
            if not np.array_equal(a, b):
                raise RuntimeError(f"phase 23 {job}: the ranks' factors differ")
    secs = time.perf_counter() - t_phase
    print(f"  launches over the mesh runs, both ranks: {total}")
    print(f"phase 23 took {secs:.1f} s (limit {MESH_PHASE_S} s): (a) "
          f"{secs_a:.1f} s (its worker's start and kernel builds included), "
          f"(b)'s plain card fits {secs_plain:.1f} s, (b)'s ranks "
          f"{secs - secs_a - secs_plain:.1f} s")
    if secs > MESH_PHASE_S:
        raise RuntimeError(f"phase 23 took {secs:.1f} s, past its "
                           f"{MESH_PHASE_S} s")
    done(23, t0)
    return total


def _rel_gap(a, b):
    """max |a - b| / |b| over a stream (0 where both are 0)."""
    den = np.where(b != 0, np.abs(b), 1.0)
    return float(np.max(np.abs(a - b) / den))


def mesh_par2_phase(dev, power):
    """Phase 24: a PARAFAC2 dataset cut along K over a mesh (its slices,
    Bk, P and mu_DeltaB the rank's; C replicated), in spawned worker
    processes.  (a) One rank over a real NCCL communicator: the PAR2 K=512
    workload through cmtf_aoadmm(mesh=) for MESH_ITERS iterations in
    float32, which must give the plain card fit's factor and stream bits
    (every collective of one rank is the identity); the roofline of the
    plain fit (utils/profiling.roofline_report).  (b) Two ranks sharing the
    card over gloo, 256 slices a rank, float64, MESH_PAR2_ITERS
    iterations: the PAR2 K=512 workload and the PARAFAC2 surface's
    tparafac2 (replicated: kernel C on each rank's whole stack), ragged
    (kernel A's lanes on each rank's ragged stack), tv (kernel B) and
    coupled (mttkrp3 on the cut
    CP block, the par2C kron system on the replicated C) configurations,
    each against the plain card fit within MESH_PAR2_FIRST_RTOL at the
    first iteration and MESH_PAR2_RUN over the run; every rank's state
    bit-equal, each configuration's kernel launched on every rank by the
    fit alone (counts set to 0 after the init, just before each fit).
    Each (b) job runs again laid out by hand (MESH_PAR2_BY_HAND): with
    every PARAFAC2 dataset replicated (the layout before the K-cut), and
    tparafac2 cut along K too (kernel C on the gathered stack), under the
    same checks, the layouts' ms an iteration side by side.  Then one
    profiling.torch_trace of a TRACE_ITERS-iteration plain PAR2 fit,
    written and read back.  Fails past MESH_PAR2_PHASE_S seconds.  Returns
    the launches by kernel over fit(mesh=)'s own runs, for the kernels
    line."""
    import tempfile
    import torch
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm
    from matlab_code_tpu_torch.utils import par2_workload, profiling
    t_phase = time.perf_counter()
    t0 = phase(24, f"PARAFAC2 cut along K over a mesh: (a) one NCCL rank, "
                   f"{MESH_ITERS} iterations; (b) two gloo ranks sharing the "
                   f"card, {MESH_PAR2_ITERS} iterations")
    spawn = multiprocessing.get_context("spawn")
    total = {"mttkrp3": 0, "sparse": 0, "D": 0, "fused": 0, "A": 0, "B": 0,
             "C": 0}

    def check(job, row):
        if "+" not in job:
            for k, v in row["launches"].items():
                total[k] += v
        missing = [k for k in MESH_PAR2_NEED[job.split("/")[0]]
                   if row["launches"][k] == 0]
        if missing:
            raise RuntimeError(f"phase 24 {job}: no launch of {missing} over "
                               "the mesh: a path fell back to a plain version")
        if not row["agree"]:
            raise RuntimeError(f"phase 24 {job}: the ranks' states differ")
        if not (np.all(np.isfinite(row["f"]))
                and np.all(np.isfinite(row["f_par2"]))):
            raise RuntimeError(f"phase 24 {job}: non-finite objective stream")

    # (a) one rank over NCCL
    job = "par2/float32"
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        m, p = pool.submit(_mesh_rank, 0, 1,
                           f"tcp://localhost:{_free_port()}", "nccl",
                           [(job, True)]).result()[job]
    secs_a = time.perf_counter() - t_phase
    check(job, m)
    same = all(np.array_equal(a, b) for a, b in zip(m["fac"], p["fac"]))
    same_f = (np.array_equal(m["f"], p["f"])
              and np.array_equal(m["f_par2"], p["f_par2"]))
    print(f"  (a) NCCL, 1 rank, {job}: ms an iteration {m['ms']:.3f} over the "
          f"mesh, {p['ms']:.3f} plain; the plain card fit's factor bits: "
          f"{same}, its f_tensors and f_PAR2_couplings streams' bits: "
          f"{same_f}; {_mesh_row_line(m)}  [{power}]")
    if not (same and same_f):
        raise RuntimeError(f"phase 24 {job}: the one-rank NCCL fit's bits "
                           "differ from the plain card fit's")
    print("  roofline of the plain PAR2 K=512 fit, float32 "
          "(utils/profiling.roofline_report): "
          + profiling.roofline_report(par2_workload.par2_spec(),
                                      p["ms"] / 1e3).replace("\n", "; ")
          + f"  [{power}]")

    # (b) two ranks over gloo, sharing the card, each job in fit(mesh=)'s
    # layout and laid out by hand (MESH_PAR2_BY_HAND); the plain card fits
    # here
    jobs_b = ["par2/float64"] + [f"par2-{c}/float64" for c in MESH_PAR2_CONFIGS]
    plain = {job: _mesh_fit(job, dev) for job in jobs_b}
    secs_plain = time.perf_counter() - t_phase - secs_a
    jobs_b += [f"{j}+{lay}" for lay, works in MESH_PAR2_BY_HAND.items()
               for j in jobs_b if j.split("/")[0] in works]
    url = f"tcp://localhost:{_free_port()}"
    with ProcessPoolExecutor(2, mp_context=spawn) as pool:
        futs = [pool.submit(_mesh_rank, r, 2, url, "gloo",
                            [(j, False) for j in jobs_b]) for r in range(2)]
        ranks = [f.result() for f in futs]
    secs_b = time.perf_counter() - t_phase - secs_a - secs_plain
    for job in jobs_b:
        p = plain[job.partition("+")[0]]
        for r, rows in enumerate(ranks):
            m = rows[job]
            check(job, m)
            first = max(_rel_gap(m["f"][1:2], p["f"][1:2]),
                        _rel_gap(m["f_par2"][1:2], p["f_par2"][1:2]))
            gap = _rel_gap(m["f"], p["f"])
            fgap = max(float(np.abs(a - b).max() / np.abs(b).max())
                       for a, b in zip(m["fac"], p["fac"]))
            print(f"  (b) gloo, rank {r} of 2, {job}: ms an iteration "
                  f"{m['ms']:.3f} over the mesh, {p['ms']:.3f} plain (one "
                  f"process alone); first iteration's streams rel gap "
                  f"{first:.3e} (bound {MESH_PAR2_FIRST_RTOL:.0e}), the "
                  f"run's f_tensors {gap:.3e}, factors {fgap:.3e} of their "
                  f"largest entry (bounds {MESH_PAR2_RUN[0]:.0e}, "
                  f"{MESH_PAR2_RUN[1]:.0e}); {_mesh_row_line(m)}  [{power}]")
            if (first > MESH_PAR2_FIRST_RTOL or gap > MESH_PAR2_RUN[0]
                    or fgap > MESH_PAR2_RUN[1]):
                raise RuntimeError(f"phase 24 {job}: rank {r} misses the "
                                   f"plain card fit ({first:.3e}, {gap:.3e}, "
                                   f"{fgap:.3e})")
        if not all(np.array_equal(a, b) for a, b in
                   zip(ranks[0][job]["fac"], ranks[1][job]["fac"])):
            raise RuntimeError(f"phase 24 {job}: the ranks' factors differ")
    for job in plain:
        ms = {lay or "fit(mesh=)'s layout": max(
            rows[f"{job}+{lay}" if lay else job]["ms"] for rows in ranks)
            for lay in ("", "replicated", "cut")
            if not lay or f"{job}+{lay}" in ranks[0]}
        print(f"  (b) {job}, the slower rank's ms an iteration: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; plain {plain[job]['ms']:.3f}  [{power}]")

    # one torch.profiler trace of a short plain fit, written and read back
    spec, data = par2_workload.build_problem(dev, torch.float32)
    opts = par2_workload.par2_options(TRACE_ITERS, AbsFuncTol=0.0,
                                      OuterRelTol=0.0)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.torch_trace(tmp) as prof:
            cmtf_aoadmm(spec, data, opts,
                        init_options=par2_workload.par2_init_options(), seed=1)
            torch.cuda.synchronize()
        nbytes = os.path.getsize(prof.trace_path)
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    print(f"  profiling.torch_trace of {TRACE_ITERS} plain PAR2 K=512 "
          f"iterations (float32, with the init and the first objective): "
          f"{nbytes / 2**20:.1f} MiB of Chrome trace, {len(events)} events, "
          f"{len(kernels)} kernel launches, {busy_ms:.3f} ms of device time  "
          f"[{power}]")
    if not kernels:
        raise RuntimeError("phase 24: the trace holds no kernel of the card")
    del data
    secs = time.perf_counter() - t_phase
    print(f"  launches over the mesh runs, both ranks: {total}")
    print(f"phase 24 took {secs:.1f} s (limit {MESH_PAR2_PHASE_S} s): (a) "
          f"{secs_a:.1f} s, (b)'s plain card fits {secs_plain:.1f} s, (b)'s "
          f"ranks {secs_b:.1f} s, the trace {secs - secs_a - secs_plain - secs_b:.1f} s")
    if secs > MESH_PAR2_PHASE_S:
        raise RuntimeError(f"phase 24 took {secs:.1f} s, past its "
                           f"{MESH_PAR2_PHASE_S} s")
    done(24, t0)
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    import matlab_code_tpu_torch as tp
    if os.path.dirname(os.path.dirname(os.path.abspath(tp.__file__))) != REPO:
        raise SystemExit(f"matlab_code_tpu_torch was imported from {tp.__file__}, "
                         f"not from the checkout at {REPO}")
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.admm import _resolve_inner_solve, to_host
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops import (
        _build, loss_cuda, mttkrp_cuda, prox_cuda, sparse_cuda)
    from matlab_code_tpu_torch.ops import tensor as tensor_ops
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3, mttkrp3_reference
    from matlab_code_tpu_torch.options import apply_matmul_precision
    from matlab_code_tpu_torch.utils import flagship
    global l2_flush, power_line, time_ms     # the timer every phase uses
    from matlab_code_tpu_torch.utils.timing import l2_flush, power_line, time_ms
    assert "jax" not in sys.modules, "the port must not load jax"

    dev = torch.device("cuda")

    # ---- 1. device and precision ------------------------------------------
    t0 = phase(1, "device and precision")
    device_name = torch.cuda.get_device_name(0)
    print("device:", device_name, "| count:", torch.cuda.device_count())
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    power = power_line()
    print("nvidia-smi name, power.limit:", power)
    apply_matmul_precision(tp.AlgOptions())
    print("allow_tf32: cuda.matmul", torch.backends.cuda.matmul.allow_tf32,
          "| cudnn", torch.backends.cudnn.allow_tf32,
          "| float32_matmul_precision", torch.get_float32_matmul_precision())
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("the default AlgOptions must run float32 in full float32")
    done(1, t0)

    # ---- 2. kernel vs plain -------------------------------------------------
    t0 = phase(2, "MTTKRP kernel vs plain")
    tb = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:    # one nvcc per source, together
        for fut in [pool.submit(mttkrp_cuda._lib), pool.submit(sparse_cuda._lib),
                    pool.submit(prox_cuda._lib), pool.submit(prox_cuda._lib_c),
                    pool.submit(loss_cuda._lib)]:
            fut.result()
    print(f"kernel libraries built and loaded in {time.perf_counter() - tb:.1f} s")
    for log in _build.BUILD_LOGS.values():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or re.search(r"\b[1-9]\d* bytes spill", line):
                print(f"ptxas: {entry}: {line.strip()}")
    rng = np.random.default_rng(0)
    max_abs_err = 0.0
    ms = plain_ms = lib_ms = bound_ms = 0.0
    bound_by_ms = {"bytes": 0.0, "operations": 0.0}
    flush = l2_flush(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, R in FLAGSHIP_SHAPES + RAGGED_SHAPES + (HBM_SHAPE,):
        X32 = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(
            sum(shape) + R), device=dev)
        f32 = [torch.tensor(rng.standard_normal((n, R)), dtype=torch.float32,
                            device=dev) for n in shape]
        X64 = X32.double()
        f64 = [f.double() for f in f32]
        timed = (shape, R) in FLAGSHIP_SHAPES + (HBM_SHAPE,)
        gb = X32.numel() * 4 / 1e9
        if timed:
            # what a plain read of X takes after the same flush
            t_r = time_ms(lambda: X32.sum(), flush)
            print(f"{shape} X.sum() (one read of X): {t_r * 1e3:.1f} us "
                  f"({gb / (t_r / 1e3):.0f} GB/s)  [{power}]")
        for mode in range(3):
            want = mttkrp3_reference(X64, f64, mode)
            scale = want.abs().max().item()
            got = mttkrp3(X32, f32, mode)
            got64 = mttkrp3(X64, f64, mode)
            torch.cuda.synchronize()
            err = (got.double() - want).abs().max().item()
            err64 = (got64 - want).abs().max().item()
            deterministic = bool(torch.equal(mttkrp3(X32, f32, mode), got)
                                 and torch.equal(mttkrp3(X64, f64, mode), got64))
            print(f"{shape} R={R} mode {mode} kernel: max|kernel-plain_f64| "
                  f"= {err:.3e} (bound {1e-4 * scale:.3e}); float64 "
                  f"{err64:.3e} (bound {1e-12 * scale:.3e}); same bits on "
                  f"repeat: {deterministic}")
            if not err <= 1e-4 * scale:
                raise RuntimeError(f"kernel disagrees: {shape} R={R} mode {mode}")
            if not err64 <= 1e-12 * scale:
                raise RuntimeError(f"float64 kernel disagrees: {shape} R={R} "
                                   f"mode {mode}")
            if not deterministic:
                raise RuntimeError(f"kernel not deterministic: {shape} mode {mode}")
            max_abs_err = max(max_abs_err, err)
            if timed:
                # X one element off an aligned pointer: modes 0/1 copy its
                # runs' envelopes, mode 2 takes 4-byte cp.async
                Xo = torch.empty(X32.numel() + 1, device=dev)[1:].view(shape)
                Xo.copy_(X32)
                got_o = mttkrp3(Xo, f32, mode)
                err_o = (got_o.double() - want).abs().max().item()
                same_o = bool(torch.equal(mttkrp3(Xo, f32, mode), got_o))
                print(f"{shape} R={R} mode {mode} X one element off: "
                      f"max|kernel-plain_f64| = {err_o:.3e} (bound "
                      f"{1e-4 * scale:.3e}); same bits on repeat: {same_o}")
                if not err_o <= 1e-4 * scale or not same_o:
                    raise RuntimeError(f"kernel disagrees on an X one element "
                                       f"off: {shape} R={R} mode {mode}")
                max_abs_err = max(max_abs_err, err_o)
                del Xo, got_o
            # a 16-bit X, widened to float32 on load: against the float64
            # plain version of the rounded X
            for dt16 in (torch.float16, torch.bfloat16):
                X16 = X32.to(dt16)
                want16 = mttkrp3_reference(X16.double(), f64, mode)
                got16 = mttkrp3(X16, f32, mode)
                err16 = (got16.double() - want16).abs().max().item()
                scale16 = want16.abs().max().item()
                same16 = bool(torch.equal(mttkrp3(X16, f32, mode), got16))
                line16 = (f"{shape} R={R} mode {mode} {dt16} X: "
                          f"max|kernel-plain_f64| = {err16:.3e} (bound "
                          f"{1e-4 * scale16:.3e}); same bits on repeat: {same16}")
                if timed:
                    t16 = time_ms(lambda: mttkrp3(X16, f32, mode), flush)
                    line16 += (f"; {t16 * 1e3:.1f} us ({X16.numel() * 2 / 1e6 / t16:.0f}"
                               f" GB/s)  [{power}]")
                print(line16)
                if got16.dtype != torch.float32 or not err16 <= 1e-4 * scale16 \
                        or not same16:
                    raise RuntimeError(f"{dt16} X disagrees: {shape} R={R} "
                                       f"mode {mode}")
                del X16, want16, got16
            del got, got64
            if R <= 32:
                plan = mttkrp_cuda.plan_mttkrp3(shape, R, mode, 4, sms)
                print(f"  mode-{mode} plan {plan}; split partials "
                      f"{plan.partial_share(shape, R):.2%} of X's bytes")
            if not timed:
                continue
            eq = ("ijk,jr,kr->ir", "ijk,ir,kr->jr", "ijk,ir,jr->kr")[mode]
            ops = [f for n, f in enumerate(f32) if n != mode]
            # X, the two factors read and the output, once each
            nbytes = 4 * (X32.numel() + sum(f.numel() for f in ops)
                          + shape[mode] * R)
            t_b, bound_by = bound(nbytes, 2 * X32.numel() * R)
            t_k = time_ms(lambda: mttkrp3(X32, f32, mode), flush)
            t_l = time_ms(lambda: torch.einsum(eq, X32, *ops), flush)
            line = (f"  time: kernel {t_k * 1e3:.1f} us ({gb / (t_k / 1e3):.0f} "
                    f"GB/s, {t_b / t_k:.1%} of the bound, {t_k / t_r:.2f}x "
                    f"X.sum()) | torch.einsum {t_l * 1e3:.1f} us | bound "
                    f"{t_b * 1e3:.1f} us ({bound_by})")
            design_probe(X32, f32, want, shape, R, mode, flush, power)
            if (shape, R) == HBM_SHAPE:
                print(f"{line}  [{power}]")
                continue
            t_p = time_ms(lambda: mttkrp3_reference(X32, f32, mode), flush)
            print(f"{line} | plain {t_p * 1e3:.1f} us  [{power}]")
            ms += t_k
            plain_ms += t_p
            lib_ms += t_l
            bound_ms += t_b
            bound_by_ms[bound_by] += t_b
        del X32, X64, f32, f64
    print(f"six flagship MTTKRPs (one sweep): kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, torch.einsum {lib_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms")
    del flush
    done(2, t0)

    # ---- 3. the flagship fit on the card ------------------------------------
    t0 = phase(3, f"flagship fit, {FIT_ITERS} outer iterations, float32")
    spec, data = flagship.build_problem(dev, torch.float32)
    print("datasets:", [tuple(X.shape) for X in data.objects],
          "| inner_solve 'auto' on CUDA ->",
          _resolve_inner_solve(tp.AlgOptions(), dev))
    opts = flagship.flagship_options(FIT_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    mttkrp3.launches = 0
    to_host.calls = 0
    zhat, state, state0, out = cmtf_aoadmm(
        spec, data, opts, init_options=flagship.flagship_init_options(),
        generator=gen)
    launches = mttkrp3.launches
    syncs = to_host.calls
    streams = np.stack([out.func_val_conv, out.func_coupl_conv,
                        out.func_constr_conv, out.func_PAR2_coupl])
    if out.OuterIterations != FIT_ITERS or streams.shape != (4, FIT_ITERS + 1):
        raise RuntimeError(f"fit ran {out.OuterIterations} iterations")
    if not np.all(np.isfinite(streams)):
        raise RuntimeError("non-finite objective stream")
    if not out.func_val_conv[-1] < out.func_val_conv[0]:
        raise RuntimeError("f_tensors did not decrease")
    if launches < 6 * FIT_ITERS:
        raise RuntimeError(f"only {launches} MTTKRP kernel launches")
    if [f.shape for f in zhat[0]["factors"]] != [(128, 16), (512, 16), (256, 16)]:
        raise RuntimeError("unexpected factor shapes")
    dts = np.diff(out.time_at_it)
    print(f"f_tensors {out.func_val_conv[0]:.6e} -> {out.f_tensors:.6e}; "
          f"f_couplings {out.f_couplings:.3e}; f_constraints "
          f"{out.f_constraints:.3e}; exit {out.exit_flag}")
    print(f"kernel launches {launches} ({launches / FIT_ITERS:.2f} per outer "
          f"iteration); host syncs {syncs} ({syncs / FIT_ITERS:.2f} per outer "
          f"iteration)")
    print(f"iterations/s {FIT_ITERS / out.time_total:.2f}; median ms per outer "
          f"iteration {np.median(dts) * 1e3:.3f} (min {dts.min() * 1e3:.3f}, "
          f"max {dts.max() * 1e3:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  [{power}]")
    init_np = state_to_numpy(state0)
    del zhat, state
    done(3, t0)

    # ---- 4. card vs CPU -------------------------------------------------------
    t0 = phase(4, f"card (float32) vs CPU (float64), {CPU_ITERS} iterations")
    opts5 = flagship.flagship_options(CPU_ITERS, AbsFuncTol=0.0, OuterRelTol=0.0)
    _, out_gpu = fit(spec, data, state_from_numpy(init_np, dev, torch.float32),
                     opts5)
    spec_c, data_c = flagship.build_problem("cpu", torch.float64)
    _, out_cpu = fit(spec_c, data_c,
                     state_from_numpy(init_np, "cpu", torch.float64), opts5)
    for label, a, b in [
            ("f_tensors", out_gpu.func_val_conv, out_cpu.func_val_conv),
            ("f_couplings", out_gpu.func_coupl_conv, out_cpu.func_coupl_conv),
            ("f_constraints", out_gpu.func_constr_conv, out_cpu.func_constr_conv),
            ("f_PAR2_couplings", out_gpu.func_PAR2_coupl, out_cpu.func_PAR2_coupl)]:
        rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))
        print(f"{label}: card {a[-1]:.9e} cpu {b[-1]:.9e} max rel diff {rel:.3e}")
        np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=label)
    del data_c
    done(4, t0)

    # ---- 5. fit to tolerance (measurement) -----------------------------------
    # the same fit three ways, from one init state: how far the iteration
    # count moves with the order of the MTTKRP's sums (the plain version:
    # torch.einsum on the card), and where float64 takes it
    t0 = phase(5, "fit to tolerance (AbsFuncTol 1e-4, OuterRelTol 1e-10)")
    kernel_path = tensor_ops.takes_kernel
    for label, dt in (("kernel, float32", torch.float32),
                      ("plain version, float32", torch.float32),
                      ("kernel, float64", torch.float64)):
        spec_t, data_t = ((spec, data) if dt == torch.float32
                          else flagship.build_problem(dev, dt))
        opts_tol = flagship.flagship_options(
            TOL_ITERS if dt == torch.float32 else TOL_ITERS_F64,
            AbsFuncTol=1e-4, OuterRelTol=1e-10)
        mttkrp3.launches = 0
        if label.startswith("plain"):
            tensor_ops.takes_kernel = lambda X: False
        try:
            _, out_tol = fit(spec_t, data_t,
                             state_from_numpy(init_np, dev, dt), opts_tol)
        finally:
            tensor_ops.takes_kernel = kernel_path
        f = np.asarray(out_tol.func_val_conv)
        reach = [int(np.argmax(f <= v)) if np.any(f <= v) else None
                 for v in TOL_MARKS]
        print(f"{label}: iterations {out_tol.OuterIterations}; exit "
              f"{out_tol.exit_flag}; f_tensors {out_tol.f_tensors:.6e}; first "
              f"iteration at f_tensors <= {TOL_MARKS}: {reach}; kernel launches "
              f"{mttkrp3.launches}; wall clock {out_tol.time_total:.3f} s  "
              f"[{power}]")
        del data_t
    done(5, t0)

    sparse = sparse_phases(dev, power)
    prox_entries = prox_phases(dev, power)
    par2 = par2_phases(dev, power)
    kl = kl_phases(dev, power)
    em = em_phases(dev, power)
    ms_launches = multistart_phase(dev, power)
    ms_rest = multistart_rest_phase(dev, power)
    ex = examples_phase(dev, power)
    bf16_phase(dev, power)
    mesh = mesh_phase(dev, power)
    mesh_par2 = mesh_par2_phase(dev, power)
    mesh = {k: v + mesh_par2[k] for k, v in mesh.items()}
    kl["D"].update(ms_rest["D"], multistart_launches=ms_rest["D_launches"])
    kl["fused"].update(ms_rest["fused"],
                       multistart_launches=ms_rest["fused_launches"])
    sparse["multistart_launches"] = ms_rest["sparse_launches"]
    for e in prox_entries:
        e.update(par2["batched"][
            "A" if e["name"] == "project_isotonic_cols" else "B"])
    prox_entries.append(par2["C"])
    for e in prox_entries:
        e["examples_launches"] = ex[{"project_isotonic_cols": "A",
                                     "prox_tv_cols": "B"}.get(e["name"], "C")]
    kl["D"]["examples_launches"] = ex["D"]
    kl["fused"]["examples_launches"] = ex["fused"]
    for e in prox_entries:
        e["mesh_launches"] = mesh[{"project_isotonic_cols": "A",
                                   "prox_tv_cols": "B"}.get(e["name"], "C")]
    kl["D"]["mesh_launches"] = mesh["D"]
    kl["fused"]["mesh_launches"] = mesh["fused"]

    print(json.dumps({"kernels": [{
        "name": "mttkrp3", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": max(bound_by_ms, key=bound_by_ms.get),
        "library_ms": lib_ms, "par2_launches": par2["mttkrp3_launches"],
        "kl_launches": kl["mttkrp3_launches"],
        "em_launches": em["EM flagship"], "pp_launches": em["pp flagship"],
        "multistart_launches": ms_launches, "examples_launches": ex["mttkrp3"],
        "mesh_launches": mesh["mttkrp3"]},
        dict(sparse, pp_launches=em["pp sparse workload"],
             examples_launches=ex["sparse"], mesh_launches=mesh["sparse"])]
        + prox_entries + [kl["D"], kl["fused"]]}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
