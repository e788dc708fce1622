"""The dense MTTKRP's share of its roofline: the least time the traced
jobs' dense 3-way MTTKRPs need (cardbench/roofline.py, counted from the
configuration and the steps run) over the device time of the port's dense
MTTKRP kernels (csrc/mttkrp3.cu) in the trace."""
import re

from cardbench import roofline

KERNELS = re.compile(r"(mttkrp3_rows_stream|mttkrp3_mode2_stream|"
                     r"reduce_splits)")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_seconds(KERNELS)
    bound = roofline.job_bound_seconds(run.shapes, run.traced_jobs)
    return 100.0 * bound / t if t > 0 and bound > 0 else None
