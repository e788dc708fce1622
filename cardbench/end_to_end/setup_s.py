"""From process start to the first timed step: imports, the CUDA context,
the kernels' libraries (built on a checkout's first run), the data on the
card and one whole job of the cell's own shapes."""


def read(run):
    return run.setup_s
