"""Eager CUDA-event ms of vocode (BigVGAN) for one batch-1 request of the
longest class (20 s), the class that sets the p95."""

LAYER = "vocoder (models/bigvgan.py)"
UNIT, MOVES, SOURCE = "ms", "request_ms_p95", "device_trace"


def read(r):
    return None if r.stages_ms is None else r.stages_ms["vocoder"]
