"""K3 launches on the tensor-core route per window request: the program's
`flash_attention.tc` counter."""

from benchmark.harness import spans

LAYER = "K3 (nn/flash_attention.py, csrc/flash_attention.cu)"
UNIT, MOVES, SOURCE = "count", "audio_s_per_s", "program_counter"


def read(r):
    return spans.launches(r, "flash_attention.tc")
