"""The card timer of chip_smoke.py, utils/time_mttkrp3.py and
utils/time_prox_seq.py: the median of CUDA events around one call, the L2
flushed before each, and the card's `nvidia-smi` name and power limit to
print beside every time.

It imports nothing of this package, so the two tools, run as files, load
it from beside them while they time another checkout's package.
"""
from __future__ import annotations

import shutil
import subprocess

import numpy as np


def l2_flush(device):
    """A 256 MB buffer whose zero_() evicts the card's 50 MB L2."""
    import torch
    return torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=device)


def time_ms(fn, flush, runs=25, warmup=3):
    """Median milliseconds of fn() on the card, L2 flushed before each run
    (the solver finds its operands cold: the other dataset's tensor passes
    through the L2 in between).  The host's overhead of a call lands in the
    time where it outlasts the flush."""
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


def power_line():
    """`name, power.limit` of the card as nvidia-smi reports it."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else f"nvidia-smi failed: {proc.stderr.strip()}"
