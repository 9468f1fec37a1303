"""From the process's start to the first timed chunk: imports, the CUDA context, the
stream made from the seed, the kernels loaded (built on a checkout's first run)
and the cell's own chunks warmed."""


def read(run):
    return run.setup_s
