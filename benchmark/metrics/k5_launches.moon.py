"""K5 launches per window request of the caption-LLM cell: the program's
`alias_free_act` counter (73 a request: the tower leaves the vocoder's
launches as they are). None where the program has no K5
(`audiolcm_torch/nn/alias_free_act.py`)."""

import importlib.util

from benchmark.harness import spans

LAYER = "K5 (nn/alias_free_act.py, csrc/alias_free_act.cu)"
UNIT, MOVES, SOURCE = "count", "request_ms_p95", "program_counter"


def read(r):
    if importlib.util.find_spec("audiolcm_torch.nn.alias_free_act") is None:
        return None
    return spans.launches(r, "alias_free_act")
