"""Profiling utilities (counterpart of matlab_code_tpu/utils/profiling.py,
without jax): a nested wall-clock phase timer, the analytic FLOP and byte
counts of one outer sweep's MTTKRP-class work, a roofline summary against
the card's published peaks, and a torch.profiler trace of a run.

    from matlab_code_tpu_torch.utils import profiling
    t = profiling.Timer()
    with t.phase("fit"):
        _, _, _, out = cmtf_aoadmm(spec, data, options, init_options=init)
    print(t.summary())
    print(profiling.roofline_report(spec, out.time_total / out.OuterIterations))
    with profiling.torch_trace("traces/fit") as prof:
        cmtf_aoadmm(spec, data, options, init_options=init)
    # prof.trace_path: a Chrome trace (chrome://tracing, Perfetto)
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np

from matlab_code_tpu_torch.problem import CP, ProblemSpec

# NVIDIA's data sheet, H100 SXM at its 700 W limit: float32 outside the
# tensor cores, and HBM3
H100_F32_FLOP_S = 6.7e13
H100_HBM_BYTES_S = 3.35e12
H100_PEAKS = ("NVIDIA H100 SXM data sheet (700 W): 67 TFLOP/s float32 "
              "outside the tensor cores, 3.35 TB/s HBM3")


@dataclass
class Timer:
    """Nested wall-clock phase timer."""
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{k:30s} {v:10.4f} s  x{self.counts[k]}"
                         for k, v in rows)


def sweep_flops(spec: ProblemSpec, dtype_bytes: int = 4) -> dict:
    """Analytic FLOPs and memory bytes of ONE outer AO sweep's MTTKRP-class
    work (the dominant cost; cmtf_fun_AOADMM.m:97 etc.): one MTTKRP a mode
    of a CP dataset, the A, Bk and C passes over a PARAFAC2 dataset's
    padded slices."""
    flops = 0
    bytes_ = 0
    for p, ds in enumerate(spec.datasets):
        R = ds.rank
        if ds.model == CP:
            sizes = [spec.mode_sizes[m] for m in ds.modes]
            nnz = int(np.prod(sizes))
            flops += 2 * nnz * R * len(sizes)      # one MTTKRP per mode
            bytes_ += nnz * dtype_bytes * len(sizes)
        else:
            K = spec.par2_K(p)
            I = spec.mode_sizes[ds.modes[0]]
            Jmax = spec.par2_Jmax(p)
            nnz = K * I * Jmax
            flops += 3 * 2 * nnz * R               # A/Bk/C sweeps
            bytes_ += 3 * nnz * dtype_bytes
    return {"flops_per_sweep": flops, "hbm_bytes_per_sweep": bytes_}


def roofline_report(spec: ProblemSpec, seconds_per_iter: float,
                    peak_flops: float | None = None,
                    peak_bw: float | None = None,
                    dtype_bytes: int = 4) -> str:
    """Roofline position of the measured outer iteration against
    peak_flops (FLOP/s) and peak_bw (bytes/s).  Without them, the H100's
    published peaks (H100_F32_FLOP_S, H100_HBM_BYTES_S), named on a third
    line; a card set below 700 W reaches less."""
    named = peak_flops is None and peak_bw is None
    peak_flops = H100_F32_FLOP_S if peak_flops is None else peak_flops
    peak_bw = H100_HBM_BYTES_S if peak_bw is None else peak_bw
    s = sweep_flops(spec, dtype_bytes)
    achieved_f = s["flops_per_sweep"] / seconds_per_iter
    achieved_b = s["hbm_bytes_per_sweep"] / seconds_per_iter
    out = (f"sweep: {s['flops_per_sweep']/1e9:.2f} GFLOP, "
           f"{s['hbm_bytes_per_sweep']/1e6:.1f} MB\n"
           f"achieved: {achieved_f/1e9:.1f} GFLOP/s "
           f"({100*achieved_f/peak_flops:.1f}% of matmul peak), "
           f"{achieved_b/1e9:.1f} GB/s "
           f"({100*achieved_b/peak_bw:.1f}% of HBM peak)")
    return out + f"\npeaks: {H100_PEAKS}" if named else out


@contextlib.contextmanager
def torch_trace(logdir: str):
    """torch.profiler over the block, CPU activity and, where a card is
    present, CUDA activity; on a normal exit the Chrome trace is written to
    logdir/trace.json (the directory made if needed) and its path set as
    the yielded profiler's `trace_path` (key_averages() reads the same
    events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.trace_path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(prof.trace_path)
