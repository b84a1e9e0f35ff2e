"""Sum of the `capture_s` of the caption-LLM cell's CUDA graphs
(aot.CapturedGenerate: each capture's eager warm-up run, the tower's
included, and the capture itself)."""

LAYER = "serving graphs (aot.CapturedGenerate, api.prewarm_buckets)"
UNIT, MOVES, SOURCE = "s", "setup_s", "program_span"


def read(r):
    return sum(r.capture_s) if r.capture_s else None
