"""Device ms of the vocoder (the `vocoder` stage) per window request of the
caption-LLM cell (batch 1, 10 s), from the program's own device stamps
inside the replayed graph (`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "vocoder (models/bigvgan.py)"
UNIT, MOVES, SOURCE = "ms", "request_ms_p95", "program_span"


def read(r):
    return spans.stage_ms(r, "vocoder")
