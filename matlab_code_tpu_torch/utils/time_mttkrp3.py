"""Time the dense MTTKRP kernel (ops/mttkrp_cuda.mttkrp3) in its three
modes at the flagship's two tensor shapes, the L2 flushed before each run,
on one CUDA card.  It serves to compare two checkouts in one call, in turns
(A, B, B, A):

    python3 matlab_code_tpu_torch/utils/time_mttkrp3.py [--root DIR] [--label NAME]

Each shape is timed with a float32 X, and then as X whose rows do not
start on 16 bytes, which the kernels copy by other routes than whole-row
bulk copies: a float32 X one element and two elements off an aligned
pointer, K one less (odd K) and a bfloat16 X one element off (X on 2
bytes).  Mode 2 copies these by 4- and 8-byte cp.async and plain copies,
modes 0/1 as bulk copies of each run's 16-byte-aligned envelope.

--root is the checkout whose matlab_code_tpu_torch is timed (by default
the one this file is in); its kernels build into that checkout.  Prints
one JSON line: the label, the card's name and power limit (nvidia-smi) and
the median milliseconds of each (shape, R, mode, case).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

SHAPES = (((128, 512, 256), 16), ((128, 1024, 64), 20))
# (case, elements X lies off an aligned pointer, K less, dtype)
CASES = (("", 0, 0, "float32"), ("one element off", 1, 0, "float32"),
         ("two elements off", 2, 0, "float32"), ("odd K", 0, 1, "float32"),
         ("bfloat16 one element off", 1, 0, "bfloat16"))


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
    # the timer beside this file: --root may be a checkout that has none
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from timing import l2_flush, power_line, time_ms
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_mttkrp3.py needs a CUDA card")
    import matlab_code_tpu_torch
    from matlab_code_tpu_torch.ops.mttkrp_cuda import mttkrp3
    pkg = os.path.dirname(os.path.abspath(matlab_code_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"matlab_code_tpu_torch came from {pkg}, not {root}")
    dev = torch.device("cuda")
    flush = l2_flush(dev)
    times = {}
    for (I, J, K0), R in SHAPES:
        for case, off, dk, dtype in CASES:
            shape = (I, J, K0 - dk)
            gen = torch.Generator(device=dev).manual_seed(I + J + K0 + R)
            n = I * J * shape[2]
            buf = torch.randn(n + off, generator=gen, device=dev)
            X = buf.to(getattr(torch, dtype))[off:].view(shape)
            facs = [torch.randn((m, R), generator=gen, device=dev) for m in shape]
            for mode in range(3):
                key = f"{(I, J, K0)} R={R} mode {mode}" + (f" {case}" if case else "")
                times[key] = time_ms(lambda: mttkrp3(X, facs, mode), flush,
                                     args.runs, args.warmup)
    print(json.dumps({"label": args.label, "root": root,
                      "device": torch.cuda.get_device_name(0),
                      "power": power_line(), "ms": times}))


if __name__ == "__main__":
    main()
