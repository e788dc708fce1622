#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (matlab_code_tpu_torch) on one
NVIDIA GPU.  Usage, from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together, into the git-ignored matlab_code_tpu_torch/_build/) and
runs eight phases, each printing its seconds; any failure raises and exits
non-zero:

  1. device and precision: the card, its power limit, the TF32 switches;
  2. dense kernel vs plain: the MTTKRP kernel (modes 0, 1, 2) against its
     plain PyTorch version in float64 on the card, at the flagship's two
     tensor shapes and at ragged shapes; times kernel vs torch.einsum;
  3. the full-size flagship fit (bench.py's workload: three CP datasets,
     type-4 selector coupling, all modes non-negative) through cmtf_aoadmm
     for 300 outer iterations in float32, counting the kernel's launches;
  4. card vs CPU: the first 5 outer iterations from one init state, on the
     card in float32 and on the CPU in float64 (plain path);
  5. fit to tolerance (AbsFuncTol 1e-4, OuterRelTol 1e-10, at most 2000
     iterations): a measurement that does not gate the result;
  6. sparse kernel vs plain: the sparse COO MTTKRP kernel (modes 0, 1, 2,
     float32 and float64) against its plain version on the card, at the
     sparse workload's size (bench_large.py's: ~1e7 nonzeros of a 2048^3
     tensor, R 16), at ragged shapes and at a case with duplicates, empty
     rows, a row of many chunks and R 40; times kernel vs plain;
  7. the full-size sparse CP fit through cmtf_aoadmm for 50 outer
     iterations in float32, counting the sparse kernel's launches;
  8. card vs CPU on the sparse path: the first 3 outer iterations from one
     init state, on the card in float32 and on the CPU in float64.

It then prints one JSON line describing both kernels, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.  It
imports nothing of JAX, and it fails without a CUDA card or without the
package beside it.
"""
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "matlab_code_tpu_torch/csrc/mttkrp3.cu"
REPLACES = "matlab_code_tpu/ops/mttkrp_pallas.py:60"
SPARSE_SOURCE = "matlab_code_tpu_torch/csrc/mttkrp_sparse.cu"
SPARSE_REPLACES = "matlab_code_tpu/ops/sparse_pallas.py:300"
FLAGSHIP_SHAPES = (((128, 512, 256), 16), ((128, 1024, 64), 20))
RAGGED_SHAPES = (((37, 50, 29), 7), ((5, 3, 130), 1))
FIT_ITERS = 300
CPU_ITERS = 5
TOL_ITERS = 2000
# (shape, draws, R, duplicated draws, extra nonzeros in row 0)
SPARSE_RAGGED = (((300, 257, 129), 20000, 7, 0, 0),
                 ((40, 23, 17), 3000, 40, 500, 3072))
SPARSE_ITERS = 50
SPARSE_CPU_ITERS = 3
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def phase(n, title):
    print(f"== phase {n}: {title}", flush=True)
    return time.perf_counter()


def done(n, t0):
    print(f"phase {n} seconds: {time.perf_counter() - t0:.3f}", flush=True)


def power_line():
    """`name, power.limit` of the card as nvidia-smi reports it."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else f"nvidia-smi failed: {proc.stderr.strip()}"


def time_ms(fn, flush, runs=25, warmup=3):
    """Median milliseconds of fn() on the card, L2 flushed before each run
    (the solver finds X cold: the other dataset's tensor passes through
    the 50 MB L2 in between)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def sparse_phases(dev, power):
    """Phases 6-8: the sparse COO path.  Returns the sparse kernel's entry
    of the kernels line."""
    import torch
    from matlab_code_tpu_torch.convert import state_from_numpy, state_to_numpy
    from matlab_code_tpu_torch.models.admm import to_host
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm, fit
    from matlab_code_tpu_torch.ops.sparse_cuda import (
        CHUNK, build_plan, lanes_for, mttkrp_sparse_cuda,
        mttkrp_sparse_reference)
    from matlab_code_tpu_torch.utils import sparse_workload as sw

    # ---- 6. sparse kernel vs plain ------------------------------------------
    t0 = phase(6, "sparse MTTKRP kernel vs plain")
    tb = time.perf_counter()
    spec, data = sw.build_problem(device=dev, dtype=torch.float32)
    st = data.objects[0]
    torch.cuda.synchronize()
    print(f"sparse workload: {st.indices.shape[0]} nonzeros of "
          f"{spec.mode_sizes}, R {sw.R}, built on the card in "
          f"{time.perf_counter() - tb:.2f} s")
    tb = time.perf_counter()
    st = st.with_plans(spec.mode_sizes)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - tb
    print(f"plans of the three modes built on the card in {plan_s:.3f} s "
          f"({[p.nchunks for p in st.plans]} chunks of <= {CHUNK} nonzeros)")
    data.objects = (st,)
    rng = np.random.default_rng(1)
    full = (spec.mode_sizes, st.indices, st.values, sw.R)
    cases = [full] + [
        (shape, torch.tensor(idx, device=dev),
         torch.tensor(val, device=dev, dtype=torch.float32), R)
        for shape, nnz, R, dup, long_row in SPARSE_RAGGED
        for idx, val, _ in [sparse_coo(shape, nnz, dup, long_row)]]
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    max_abs_err = ms = plain_ms = bound_ms = 0.0
    bound_by_ms = {"bytes": 0.0, "operations": 0.0}
    for n_case, (shape, idx, val32, R) in enumerate(cases):
        facs = [rng.standard_normal((d, R)) for d in shape]
        f32 = [torch.tensor(f, dtype=torch.float32, device=dev) for f in facs]
        f64 = [f.double() for f in f32]
        val64 = val32.double()
        nnz = idx.shape[0]
        for mode in range(3):
            p32 = st.plans[mode] if n_case == 0 else build_plan(idx, val32, shape, mode)
            p64 = build_plan(idx, val64, shape, mode)
            want = mttkrp_sparse_reference(idx, val64, f64, mode, shape[mode])
            scale = want.abs().max().item()
            got = mttkrp_sparse_cuda(p32, f32)
            got64 = mttkrp_sparse_cuda(p64, f64)
            torch.cuda.synchronize()
            err = (got.double() - want).abs().max().item()
            err64 = (got64 - want).abs().max().item()
            same = bool(torch.equal(mttkrp_sparse_cuda(p32, f32), got)
                        and torch.equal(mttkrp_sparse_cuda(p64, f64), got64))
            print(f"{shape} nnz={nnz} R={R} mode {mode}: max|kernel-plain_f64| "
                  f"= {err:.3e} (bound {1e-4 * scale:.3e}); float64 kernel "
                  f"{err64:.3e} (bound {1e-12 * scale:.3e}); same bits on "
                  f"repeat: {same}")
            if not err <= 1e-4 * scale:
                raise RuntimeError(f"sparse kernel disagrees: {shape} mode {mode}")
            if not err64 <= 1e-12 * scale:
                raise RuntimeError(f"float64 sparse kernel disagrees: {shape} "
                                   f"mode {mode}")
            if not same:
                raise RuntimeError(f"sparse kernel not deterministic: {shape} "
                                   f"mode {mode}")
            max_abs_err = max(max_abs_err, err)
            del p64, want, got64
            if n_case == 0:
                t_k = time_ms(lambda: mttkrp_sparse_cuda(p32, f32), flush)
                t_p = time_ms(lambda: mttkrp_sparse_reference(
                    idx, val32, f32, mode, shape[mode]), flush, runs=10)
                # the plan (coords, values, chunk tables), the gathered
                # factors and the output, once each; 3R flops a nonzero
                stream = nnz * (2 * 4 + 4)
                nbytes = (stream + 8 * (p32.chunk_start.numel()
                                        + p32.chunk_ptr.numel())
                          + 4 * R * sum(shape))
                t_b, bound_by = bound(nbytes, 3 * nnz * R)
                print(f"  time: kernel {t_k * 1e3:.1f} us ({stream / 1e6 / t_k:.0f}"
                      f" GB/s of the 12 B/nnz stream, {t_b / t_k:.1%} of the "
                      f"{t_b * 1e3:.1f} us bound, {bound_by}; gathered rows "
                      f"{8 * R * nnz / 1e6 / t_k:.0f} GB/s) | plain "
                      f"{t_p * 1e3:.1f} us; {lanes_for(R)} lanes per nonzero  "
                      f"[{power}]")
                ms += t_k
                plain_ms += t_p
                bound_ms += t_b
                bound_by_ms[bound_by] += t_b
        del f32, f64, val64
    print(f"three sparse MTTKRPs (one sweep) at full size: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms")
    # which roof sets the pace: other ranks read the same 12 B/nnz stream
    # but gather 4R bytes a factor row
    nnz = st.indices.shape[0]
    for R in (8, 32):
        fr = [torch.rand((d, R), device=dev) for d in spec.mode_sizes]
        t_k = time_ms(lambda: mttkrp_sparse_cuda(st.plans[0], fr), flush)
        print(f"  rank probe, full size, mode 0, R {R}: kernel {t_k * 1e3:.1f} us"
              f" (stream {12 * nnz / 1e6 / t_k:.0f} GB/s, gathered rows "
              f"{8 * R * nnz / 1e6 / t_k:.0f} GB/s)  [{power}]")
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
    from matlab_code_tpu_torch.ops import _build, mttkrp_cuda, sparse_cuda
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3, mttkrp3_reference
    from matlab_code_tpu_torch.options import apply_matmul_precision
    from matlab_code_tpu_torch.utils import flagship
    assert "jax" not in sys.modules, "the port must not load jax"

    dev = torch.device("cuda")

    # ---- 1. device and precision ------------------------------------------
    t0 = phase(1, "device and precision")
    name = torch.cuda.get_device_name(0)
    print("device:", name, "| count:", torch.cuda.device_count())
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
    with ThreadPoolExecutor(2) as pool:    # one nvcc per source, together
        for fut in [pool.submit(mttkrp_cuda._lib), pool.submit(sparse_cuda._lib)]:
            fut.result()
    print(f"kernel libraries built and loaded in {time.perf_counter() - tb:.1f} s")
    for log in _build.BUILD_LOGS.values():
        for line in log.splitlines():
            if "registers" in line:
                print("ptxas:", line.strip())
    rng = np.random.default_rng(0)
    max_abs_err = 0.0
    ms = plain_ms = lib_ms = bound_ms = 0.0
    bound_by_ms = {"bytes": 0.0, "operations": 0.0}
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    for shape, R in FLAGSHIP_SHAPES + RAGGED_SHAPES:
        X = rng.standard_normal(shape).astype(np.float32)
        facs = [rng.standard_normal((n, R)).astype(np.float32) for n in shape]
        X32 = torch.tensor(X, device=dev)
        f32 = [torch.tensor(f, device=dev) for f in facs]
        X64 = X32.double()
        f64 = [f.double() for f in f32]
        for mode in range(3):
            want = mttkrp3_reference(X64, f64, mode)
            scale = want.abs().max().item()
            got = mttkrp3(X32, f32, mode)
            got64 = mttkrp3(X64, f64, mode)
            torch.cuda.synchronize()
            err = (got.double() - want).abs().max().item()
            err64 = (got64 - want).abs().max().item()
            again = mttkrp3(X32, f32, mode)
            deterministic = bool(torch.equal(again, got))
            print(f"{shape} R={R} mode {mode}: max|kernel-plain_f64| = {err:.3e} "
                  f"(bound {1e-4 * scale:.3e}); float64 kernel {err64:.3e}; "
                  f"same bits on repeat: {deterministic}")
            if not err <= 1e-4 * scale:
                raise RuntimeError(f"kernel disagrees: {shape} R={R} mode {mode}")
            if not err64 <= 1e-12 * scale:
                raise RuntimeError(f"float64 kernel disagrees: {shape} R={R} mode {mode}")
            if not deterministic:
                raise RuntimeError(f"kernel not deterministic: {shape} mode {mode}")
            max_abs_err = max(max_abs_err, err)
            if (shape, R) in FLAGSHIP_SHAPES:
                eq = ("ijk,jr,kr->ir", "ijk,ir,kr->jr", "ijk,ir,jr->kr")[mode]
                ops = [f for n, f in enumerate(f32) if n != mode]
                t_k = time_ms(lambda: mttkrp3(X32, f32, mode), flush)
                t_p = time_ms(lambda: mttkrp3_reference(X32, f32, mode), flush)
                t_l = time_ms(lambda: torch.einsum(eq, X32, *ops), flush)
                # X, the two factors read and the output, once each
                nbytes = 4 * (X32.numel() + sum(f.numel() for f in ops)
                              + shape[mode] * R)
                t_b, bound_by = bound(nbytes, 2 * X32.numel() * R)
                gb = X32.numel() * 4 / 1e9
                print(f"  time: kernel {t_k * 1e3:.1f} us ({gb / (t_k / 1e3):.0f} GB/s)"
                      f" | plain {t_p * 1e3:.1f} us "
                      f"({gb / (t_p / 1e3):.0f} GB/s) | torch.einsum "
                      f"{t_l * 1e3:.1f} us | bound {t_b * 1e3:.1f} us "
                      f"({bound_by})  [{power}]")
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
    t0 = phase(5, "fit to tolerance (AbsFuncTol 1e-4, OuterRelTol 1e-10)")
    opts_tol = flagship.flagship_options(TOL_ITERS, AbsFuncTol=1e-4,
                                         OuterRelTol=1e-10)
    _, out_tol = fit(spec, data, state_from_numpy(init_np, dev, torch.float32),
                     opts_tol)
    print(f"iterations {out_tol.OuterIterations}; exit {out_tol.exit_flag}; "
          f"f_tensors {out_tol.f_tensors:.6e}; wall clock "
          f"{out_tol.time_total:.3f} s  [{power}]")
    done(5, t0)

    sparse = sparse_phases(dev, power)

    print(json.dumps({"kernels": [{
        "name": "mttkrp3", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": max(bound_by_ms, key=bound_by_ms.get),
        "library_ms": lib_ms},
        sparse]}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
