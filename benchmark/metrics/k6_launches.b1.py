"""K6 launches per window request of the batch-1 mix, every clip length
alike: the program's `wide_conv` counter. None where the program has no K6
(`audiolcm_torch/nn/wide_conv.py`)."""

import importlib.util

from benchmark.harness import spans

LAYER = "K6 (nn/wide_conv.py, csrc/wide_conv.cu)"
UNIT, MOVES, SOURCE = "count", "request_ms_p95", "program_counter"


def read(r):
    if importlib.util.find_spec("audiolcm_torch.nn.wide_conv") is None:
        return None
    return spans.launches(r, "wide_conv")
