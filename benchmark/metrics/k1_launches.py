"""K1 launches on the tensor-core route per window request: the program's
`amp_stage.mma` counter, which counts each replay of a captured launch."""

from benchmark.harness import spans

LAYER = "K1 (nn/amp_stage.py, csrc/amp_stage.cu)"
UNIT, MOVES, SOURCE = "count", "audio_s_per_s", "program_counter"


def read(r):
    return spans.launches(r, "amp_stage.mma")
