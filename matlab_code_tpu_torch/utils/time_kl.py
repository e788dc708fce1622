"""Time the KL workload (utils/kl_workload.py: 128 x 256 x 256 Poisson
counts, rank 8) end to end on one CUDA card: one start's fit and
fit_multistart's starts on the start axis (utils/multistart_workload.
kl_problem), each for a few outer iterations.  It serves to compare two
checkouts in one call, in turns (A, B, B, A):

    python3 matlab_code_tpu_torch/utils/time_kl.py [--root DIR] [--label NAME] [--iters 5] [--starts 20]

For each run: the median and p90 ms an outer iteration, the peak device
memory, the device reads (models/admm.to_host) and the launches an
iteration of every kernel D entry and of mttkrp3 the checkout has, and,
under torch.profiler over two more iterations, the device's busy share
of the wall clock and its calls.

--root is the checkout whose matlab_code_tpu_torch is timed (by default
the one this file is in); its kernels build into that checkout.  Prints
one JSON line: the label, the card's name and power limit (nvidia-smi)
and the numbers of both runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _counters():
    """{name: wrapper} of the launch counters this checkout has."""
    from matlab_code_tpu_torch.ops import loss_cuda
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    out = {"old_pass": loss_cuda.loss_fg_cuda, "mttkrp3": mttkrp3}
    if hasattr(loss_cuda, "loss_fg_mttkrp_cuda"):
        out["fused"] = loss_cuda.loss_fg_mttkrp_cuda
    return out


def _busy(run):
    """(device busy share of the wall clock, device calls) of run()."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows)
    return busy / wall, sum(e.count for e in rows)


def _measure(run, iters):
    """Run a fit (run(n) -> its output) of `iters` iterations with the
    counts at 0, then one of 2 under the profiler."""
    import torch
    from matlab_code_tpu_torch.models.admm import to_host
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    to_host.calls = 0
    out = run(iters)
    torch.cuda.synchronize()
    n = out.OuterIterations
    dts = np.diff(out.time_at_it) * 1e3
    row = {"ms": float(np.median(dts)), "p90": float(np.percentile(dts, 90)),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "reads": to_host.calls / n, "f_tensors": float(out.f_tensors),
           "launches": {k: fn.launches / n for k, fn in counters.items()}}
    row["busy"], row["device_calls"] = _busy(lambda: run(2))
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--starts", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # the timer beside this file: --root may be a checkout that has none
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from timing import power_line
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kl.py needs a CUDA card")
    import matlab_code_tpu_torch
    pkg = os.path.dirname(os.path.abspath(matlab_code_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"matlab_code_tpu_torch came from {pkg}, not {root}")
    from matlab_code_tpu_torch.models.multistart import fit_multistart
    from matlab_code_tpu_torch.models.solver import cmtf_aoadmm
    from matlab_code_tpu_torch.utils import kl_workload as klw
    from matlab_code_tpu_torch.utils import multistart_workload as mw
    dev = torch.device("cuda")
    spec, data, state0, _ = klw.build_problem(dev, torch.float32)

    def one(n):
        opts = klw.kl_options(n, AbsFuncTol=0.0, OuterRelTol=0.0)
        return cmtf_aoadmm(spec, data, opts, init=state0)[3]

    one(1)      # builds the kernels
    _busy(lambda: None)     # the profiler's start-up, outside the readings
    res = {"label": args.label, "power": power_line(),
           "fit": _measure(one, args.iters)}
    del data, state0
    spec, data, opts, init = mw.kl_problem(dev, torch.float32)

    def many(n):
        o = dataclasses.replace(opts, MaxOuterIters=n, AbsFuncTol=0.0,
                                OuterRelTol=0.0)
        return fit_multistart(spec, data, o, init, args.starts,
                              keys=range(args.starts))[1]

    many(1)
    res["multistart"] = _measure(many, args.iters)
    res["starts"] = args.starts
    print(json.dumps(res))


if __name__ == "__main__":
    main()
