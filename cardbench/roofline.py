"""The yardstick of the kernel and step metrics: the card's published peaks
and the operations and bytes of a job's data-term products (MTTKRPs),
counted from the configuration and the steps run, never from a launch
counter, so that the count stays the same whatever kernel (or how many
launches) computes the products.

Counts are the minimum traffic: each input byte read once and
each output byte written once, whatever the kernel reads again.
  dense  (I, J, K) mode m:  X once, the two gathered factors once, the
         output written once, for the S starts that step together (X is
         read once for all of them);
  operations: 2 (elements) R S in float32, one multiply-add a column and
         element (a 3-way term takes a second multiply, left out, so that
         the count never runs high); a matrix's product X F or X^T F the
         same.
The bound is the larger of bytes over the memory bandwidth and operations
over the float32 rate (the H100 SXM data sheet, 700 W); the run prints the
card's power limit beside every share.
"""
from __future__ import annotations

import math

PEAK_FLOPS_FP32 = 67e12       # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12    # HBM3
PEAK_SOURCE = "NVIDIA H100 SXM data sheet: 67 TFLOP/s float32, 3.35 TB/s"


def dense_mttkrp(shape, mode: int, R: int, starts: int = 1,
                 itemsize: int = 4):
    """(bytes, operations) of one mode-`mode` MTTKRP of a dense tensor for
    `starts` starts of rank R."""
    numel = math.prod(shape)
    rows = sum(shape) - shape[mode]
    nbytes = numel * itemsize + starts * R * itemsize * (rows + shape[mode])
    return nbytes, 2 * numel * R * starts


def bound_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS_FP32)


def mttkrp_products(order: int, n_starts: int, stop_iters):
    """[(mode, starts)] of the data-term products a job of a dataset of
    `order` modes needs: each start's first objective (one mode-0 product
    of every start, taken together), then one product a mode a step for
    the starts still stepping (start s steps stop_iters[s] times)."""
    out = [(0, n_starts)]
    for t in range(1, max(stop_iters) + 1):
        running = sum(1 for n in stop_iters if n >= t)
        out += [(m, running) for m in range(order)]
    return out


def job_bound_seconds(datasets, jobs) -> float:
    """The least device time the dense 3-way MTTKRPs of `jobs` need,
    summed over every 3-way dataset (datasets: shapes and ranks, as
    check.shapes_of gives them; jobs: objects with n_starts and
    stop_iters)."""
    total = 0.0
    for d in datasets:
        if len(d["shape"]) != 3:
            continue
        for job in jobs:
            for mode, starts in mttkrp_products(3, job.n_starts,
                                                job.stop_iters):
                total += bound_seconds(*dense_mttkrp(d["shape"], mode,
                                                     d["rank"], starts))
    return total


def job_operations(datasets, jobs) -> float:
    """The float32 operations of every dataset's data-term products in
    `jobs` (the steps' least work: the inner solves, Gram matrices and
    proxes are left out)."""
    total = 0.0
    for d in datasets:
        numel = math.prod(d["shape"])
        for job in jobs:
            total += sum(2 * numel * d["rank"] * starts for _, starts in
                         mttkrp_products(len(d["shape"]), job.n_starts,
                                         job.stop_iters))
    return total
