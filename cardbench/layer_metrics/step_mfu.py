"""The whole step's share of the card's float32 peak: the operations of
the traced jobs' data-term products (cardbench/roofline.py, counted from
the configuration and the steps run; the rest of a step's work is left
out, so the share never reads high) over the profiled span's wall time at
67 TFLOP/s."""
from cardbench import roofline


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not run.traced_jobs:
        return None
    ops = roofline.job_operations(run.shapes, run.traced_jobs)
    return 100.0 * ops / (tr.window_s * roofline.PEAK_FLOPS_FP32)
