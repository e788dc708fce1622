"""Every start's outer iterations completed in the window over the window's
wall time (each job's seeded init and first objective inside it)."""


def read(run):
    return sum(j.start_iters for j in run.jobs) / run.window_s
