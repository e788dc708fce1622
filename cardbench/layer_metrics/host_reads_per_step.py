"""Device reads by the host (the port's models/admm.to_host.calls) over the
window's steps (outer iterations of a job, all starts together)."""


def read(run):
    steps = sum(j.steps for j in run.jobs)
    return run.host_reads / steps if steps else None
