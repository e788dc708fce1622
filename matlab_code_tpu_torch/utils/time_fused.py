"""Time the fused evaluation of kernel D (ops/loss_cuda.loss_fg_mttkrp_cuda)
against the three-call evaluation it replaces (ktensor_full by
torch.einsum, the old pass loss_fg_cuda, ops/tensor.mttkrp: mttkrp3 on the
card) on one CUDA card, at the KL workload's 128 x 256 x 256 over ranks
and dtypes, modes 0-2:

    python3 matlab_code_tpu_torch/utils/time_fused.py [--ranks 8 16 32 40 48 64] [--dtypes float32 float64]

Each time is given twice: the median of CUDA events around one call with
the L2 flushed before it (utils/timing.time_ms: the host's time lands in
it where it outlasts the flush), and the device time of a call under
torch.profiler (the flush's own kernel left out).  Beside the grid,
at rank 8 in float32: the fused KL call against the fused beta-2 call
(whose fh and gh are products and sums only: no division, no log), the
f-only pass, and X.sum() (one read of X by a library reduction).  It also
times the build of the loss_fg library (one nvcc) where it is not built
yet.  chip_smoke.py's phase 14 calls route_grid and probes.  Prints the
card's name and power limit (nvidia-smi), then one JSON line, also written
to chiprun_out/time_fused.json.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

SHAPE = (128, 256, 256)     # the KL workload's (utils/kl_workload.py)
EPS_LOG = 1e-10


def problem(shape, R, dtype, device, seed):
    """Factors U(0.1, 1.1) of rank R and Poisson counts of their model, on
    the card in dtype."""
    import torch
    from matlab_code_tpu_torch.ops.tensor import ktensor_full
    rng = np.random.default_rng(seed)
    facs = [torch.tensor(rng.uniform(0.1, 1.1, size=(n, R)), device=device)
            for n in shape]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.poisson(ktensor_full(facs), generator=gen)
    return X.to(dtype), [F.to(dtype) for F in facs]


def device_us(fn, flush, reps=20):
    """Device microseconds of one fn() under torch.profiler, the L2 flushed
    before each call.  The flush fills the buffer as bytes, a kernel
    (FillFunctor<unsigned char>) that no timed call launches, and its time
    is left out by that name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush8 = flush.view(torch.uint8)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush8.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "FillFunctor<unsigned char>" not in e.key) / reps


def three_call(loss, X, facs, mode, beta=None):
    """The evaluation the fused kernel replaces: the model by torch.einsum,
    the old pass, the MTTKRP of gh (mttkrp3 on the card)."""
    from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_cuda
    from matlab_code_tpu_torch.ops.tensor import ktensor_full, mttkrp
    f, Y = loss_fg_cuda(loss, X, ktensor_full(facs).contiguous(), EPS_LOG,
                        beta)
    return f, mttkrp(Y, facs, mode)


def route_grid(device, flush, ranks, dtypes, shape=SHAPE, modes=(0, 1, 2)):
    """Rows {dtype, R, mode, fused_ms, three_ms, fused_dev_us,
    three_dev_us} of the KL evaluation at `shape`."""
    import torch
    from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_mttkrp_cuda
    from matlab_code_tpu_torch.utils.timing import time_ms
    rows = []
    for dt in dtypes:
        for R in ranks:
            X, facs = problem(shape, R, dt, device, 300 + R)
            for mode in modes:
                def fused():
                    return loss_fg_mttkrp_cuda("KL", X, facs, mode, EPS_LOG)

                def old():
                    return three_call("KL", X, facs, mode)
                rows.append({
                    "dtype": str(dt).replace("torch.", ""), "R": R,
                    "mode": mode, "fused_ms": time_ms(fused, flush),
                    "three_ms": time_ms(old, flush),
                    "fused_dev_us": device_us(fused, flush),
                    "three_dev_us": device_us(old, flush)})
            del X, facs
            torch.cuda.empty_cache()
    return rows


def probes(device, flush, shape=SHAPE, R=8):
    """At rank R in float32, mode 0: {name: (ms, device us)} of the fused
    KL call, the fused beta-2 call (fh and gh without a division or a
    log), the f-only KL pass and X.sum()."""
    import torch
    from matlab_code_tpu_torch.ops.loss_cuda import loss_fg_mttkrp_cuda
    from matlab_code_tpu_torch.utils.timing import time_ms
    X, facs = problem(shape, R, torch.float32, device, 300 + R)
    calls = {
        "fused_kl": lambda: loss_fg_mttkrp_cuda("KL", X, facs, 0, EPS_LOG),
        "fused_beta2": lambda: loss_fg_mttkrp_cuda("beta", X, facs, 0,
                                                   EPS_LOG, 2.0),
        "f_only_kl": lambda: loss_fg_mttkrp_cuda("KL", X, facs, 0, EPS_LOG,
                                                 grad=False),
        "x_sum": lambda: X.sum()}
    return {k: (time_ms(fn, flush), device_us(fn, flush))
            for k, fn in calls.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+",
                    default=[8, 16, 32, 40, 48, 64])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "float64"])
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_fused.py needs a CUDA card")
    from matlab_code_tpu_torch.ops import _build, loss_cuda
    from matlab_code_tpu_torch.utils.timing import l2_flush, power_line
    dev = torch.device("cuda")
    power = power_line()
    print("nvidia-smi name, power.limit:", power)
    fresh = not _build.library_path("loss_fg", ["loss_fg.cu"]).exists()
    t = time.perf_counter()
    loss_cuda._lib()
    build_s = time.perf_counter() - t
    print(f"loss_fg library {'built and ' if fresh else ''}loaded in "
          f"{build_s:.1f} s (one nvcc)")
    for log in _build.BUILD_LOGS.values():    # the instances that spill
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif re.search(r"\b[1-9]\d* bytes spill", line):
                print(f"ptxas: {entry}: {line.strip()}")
    flush = l2_flush(dev)
    device_us(lambda: None, flush, reps=1)    # the profiler's start-up
    res = {"power": power, "build_s": build_s if fresh else None,
           "probes": probes(dev, flush)}
    for k, (ms, us) in res["probes"].items():
        print(f"probe {k}: {ms * 1e3:.1f} us events, {us:.1f} us device  "
              f"[{power}]")
    dtypes = [getattr(torch, d) for d in args.dtypes]
    res["grid"] = route_grid(dev, flush, args.ranks, dtypes)
    for r in res["grid"]:
        print(f"{r['dtype']} R {r['R']} mode {r['mode']}: fused "
              f"{r['fused_ms'] * 1e3:.1f} us ({r['fused_dev_us']:.1f} device), "
              f"three-call {r['three_ms'] * 1e3:.1f} us "
              f"({r['three_dev_us']:.1f} device)  [{power}]")
    out = os.path.join(root, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "time_fused.json"), "w") as fh:
        json.dump(res, fh)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
