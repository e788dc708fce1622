"""Time the dense MTTKRP kernel (ops/mttkrp_cuda.mttkrp3) in its three
modes at the flagship's two tensor shapes, float32, the L2 flushed before
each run, on one CUDA card.  It serves to compare two checkouts in one
call, in turns (A, B, B, A):

    python3 matlab_code_tpu_torch/utils/time_mttkrp3.py [--root DIR] [--label NAME]

--root is the checkout whose matlab_code_tpu_torch is timed (by default
the one this file is in); its kernels build into that checkout.  Prints
one JSON line: the label, the card's name and power limit (nvidia-smi) and
the median milliseconds of each (shape, R, mode).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

SHAPES = (((128, 512, 256), 16), ((128, 1024, 64), 20))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=50)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_mttkrp3.py needs a CUDA card")
    import matlab_code_tpu_torch
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    pkg = os.path.dirname(os.path.abspath(matlab_code_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"matlab_code_tpu_torch came from {pkg}, not {root}")
    dev = torch.device("cuda")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    times = {}
    for shape, R in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(sum(shape) + R)
        X = torch.randn(shape, generator=gen, device=dev)
        facs = [torch.randn((n, R), generator=gen, device=dev) for n in shape]
        for mode in range(3):
            for _ in range(args.warmup):
                flush.zero_()
                mttkrp3(X, facs, mode)
            ts = []
            for _ in range(args.runs):
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                mttkrp3(X, facs, mode)
                end.record()
                torch.cuda.synchronize()
                ts.append(start.elapsed_time(end))
            times[f"{shape} R={R} mode {mode}"] = float(np.median(ts))
    power = None
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        power = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps({"label": args.label, "root": root,
                      "device": torch.cuda.get_device_name(0),
                      "power": power, "ms": times}))


if __name__ == "__main__":
    main()
