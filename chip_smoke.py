#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (matlab_code_tpu_torch) on one
NVIDIA GPU.  Usage, from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (nvcc, into the git-ignored
matlab_code_tpu_torch/_build/) and runs five phases, each printing its
seconds; any failure raises and exits non-zero:

  1. device and precision: the card, its power limit, the TF32 switches;
  2. kernel vs plain: the MTTKRP kernel (modes 0, 1, 2) against its plain
     PyTorch version in float64 on the card, at the flagship's two tensor
     shapes and at ragged shapes; times kernel vs torch.einsum;
  3. the full-size flagship fit (bench.py's workload: three CP datasets,
     type-4 selector coupling, all modes non-negative) through cmtf_aoadmm
     for 300 outer iterations in float32, counting the kernel's launches;
  4. card vs CPU: the first 5 outer iterations from one init state, on the
     card in float32 and on the CPU in float64 (plain path);
  5. fit to tolerance (AbsFuncTol 1e-4, OuterRelTol 1e-10, at most 2000
     iterations): a measurement that does not gate the result.

It then prints one JSON line describing the kernel, the card's name and
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

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "matlab_code_tpu_torch/csrc/mttkrp3.cu"
REPLACES = "matlab_code_tpu/ops/mttkrp_pallas.py:60"
FLAGSHIP_SHAPES = (((128, 512, 256), 16), ((128, 1024, 64), 20))
RAGGED_SHAPES = (((37, 50, 29), 7), ((5, 3, 130), 1))
FIT_ITERS = 300
CPU_ITERS = 5
TOL_ITERS = 2000


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
    from matlab_code_tpu_torch.ops import _build, mttkrp_cuda
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
    mttkrp_cuda._lib()
    print(f"kernel library built and loaded in {time.perf_counter() - tb:.1f} s")
    for log in _build.BUILD_LOGS.values():
        for line in log.splitlines():
            if "registers" in line:
                print("ptxas:", line.strip())
    rng = np.random.default_rng(0)
    max_abs_err = 0.0
    ms = plain_ms = 0.0
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
                t_k = time_ms(lambda: mttkrp3(X32, f32, mode), flush)
                t_p = time_ms(lambda: mttkrp3_reference(X32, f32, mode), flush)
                gb = X32.numel() * 4 / 1e9
                print(f"  time: kernel {t_k * 1e3:.1f} us ({gb / (t_k / 1e3):.0f} GB/s)"
                      f" | torch.einsum {t_p * 1e3:.1f} us "
                      f"({gb / (t_p / 1e3):.0f} GB/s)  [{power}]")
                ms += t_k
                plain_ms += t_p
        del X32, X64, f32, f64
    print(f"six flagship MTTKRPs (one sweep): kernel {ms:.3f} ms, "
          f"einsum {plain_ms:.3f} ms")
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

    print(json.dumps({"kernels": [{
        "name": "mttkrp3", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
