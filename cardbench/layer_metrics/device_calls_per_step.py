"""Device operations (kernels, copies, sets) in the profiler's trace over
the traced jobs' steps."""


def read(run):
    steps = sum(j.steps for j in run.traced_jobs)
    if run.trace is None or not steps or not run.trace.dev_names:
        return None
    return len(run.trace.dev_names) / steps
