"""Process start to the first measured request: weights, the pipeline,
the cell's graph captures and warm requests (and, in a checkout's first
run, the kernels' nvcc build)."""

LAYER, UNIT, MOVES, SOURCE = "end to end", "s", None, "host_clock"


def read(r):
    return r.setup_s
