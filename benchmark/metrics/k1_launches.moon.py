"""K1 launches on the tensor-core route per window request of the
caption-LLM cell: the program's `amp_stage.mma` counter, which counts each
replay of a captured launch (2 a request: the vocoder's two fused
stages)."""

from benchmark.harness import spans

LAYER = "K1 (nn/amp_stage.py, csrc/amp_stage.cu)"
UNIT, MOVES, SOURCE = "count", "request_ms_p95", "program_counter"


def read(r):
    return spans.launches(r, "amp_stage.mma")
