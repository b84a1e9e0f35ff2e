"""K6 launches per window request: the program's `wide_conv` counter, which
counts each replay of a captured launch (72 in a request: 4 unfused stages
x 3 resblocks x 6 convs). None where the program has no K6
(`audiolcm_torch/nn/wide_conv.py`)."""

import importlib.util

from benchmark.harness import spans

LAYER = "K6 (nn/wide_conv.py, csrc/wide_conv.cu)"
UNIT, MOVES, SOURCE = "count", "audio_s_per_s", "program_counter"


def read(r):
    if importlib.util.find_spec("audiolcm_torch.nn.wide_conv") is None:
        return None
    return spans.launches(r, "wide_conv")
