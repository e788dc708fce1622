"""Time the sequential-prox kernels (ops/prox_cuda: kernel A,
project_isotonic_cols; kernel B, prox_tv_cols) through their public
wrappers, on the route each checkout's own plan takes, the L2 flushed
before each run, on one CUDA card.  It serves to compare two checkouts in
one call, in turns (A, B, B, A):

    python3 matlab_code_tpu_torch/utils/time_prox_seq.py [--root DIR] [--label NAME]

Each (n, R) is timed in float32 on two kinds of column: "normal" (standard
normal draws) and "smooth" (a unimodal bump plus noise of 0.05, what a
fitted unimodal factor looks like, so few merges and many level sets or
segments).  Kernel A runs the non-negative unimodal projection; kernel B
the TV prox at lam 1e-3 (a jump almost every state on normal columns) and
lam 1.0 (long segments, a division most states).

--root is the checkout whose matlab_code_tpu_torch is timed (by default
the one this file is in); its kernels build into that checkout.  Prints a
line a case (µs, ns a row) and one JSON line: the label, the card's name
and power limit (nvidia-smi) and the median milliseconds of each (kernel,
n, R, column, lam).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

SHAPES = ((512, 16), (256, 16), (4096, 20))
COLUMNS = ("normal", "smooth")
TV_LAMS = (1e-3, 1.0)


def columns(kind: str, n: int, R: int, seed: int = 3):
    """An (n, R) float64 numpy matrix of the named kind of column."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((n, R))
    t = np.linspace(0.0, 1.0, n)[:, None]
    centre = rng.uniform(0.2, 0.8, R)[None, :]
    width = rng.uniform(0.05, 0.3, R)[None, :]
    return np.exp(-((t - centre) / width) ** 2) + 0.05 * rng.standard_normal((n, R))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # the timer beside this file: --root may be a checkout that has none
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from timing import l2_flush, power_line, time_ms
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_prox_seq.py needs a CUDA card")
    import matlab_code_tpu_torch
    from matlab_code_tpu_torch.ops import prox_cuda
    pkg = os.path.dirname(os.path.abspath(matlab_code_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"matlab_code_tpu_torch came from {pkg}, not {root}")
    dev = torch.device("cuda")
    flush = l2_flush(dev)
    times = {}
    for n, R in SHAPES:
        for col in COLUMNS:
            X = torch.tensor(columns(col, n, R), dtype=torch.float32, device=dev)
            cases = [(f"A {n}x{R} {col}",
                      lambda: prox_cuda.project_isotonic_cols(X, 2, True))]
            for lam in TV_LAMS:
                lam_d = torch.tensor(lam, dtype=torch.float64, device=dev)
                cases.append((f"B {n}x{R} {col} lam {lam}",
                              lambda lam_d=lam_d: prox_cuda.prox_tv_cols(X, lam_d)))
            for key, fn in cases:
                t = time_ms(fn, flush, args.runs, args.warmup)
                times[key] = t
                print(f"{args.label} kernel {key}: {t * 1e3:.1f} us "
                      f"({t / n * 1e6:.1f} ns a row)", flush=True)
    print(json.dumps({"label": args.label, "root": root,
                      "power": power_line(), "ms": times}))


if __name__ == "__main__":
    main()
