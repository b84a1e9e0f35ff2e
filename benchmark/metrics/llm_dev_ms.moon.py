"""Device ms of the caption LLM (the `llm` stage of the generate: the
Moonlight tower's 27 layers, K7 in its 26 expert layers) per window
request, from the program's own device stamps (`audiolcm_torch.obs`);
None on a program without the stage."""

from benchmark.harness import spans

LAYER = "caption LLM (models/moe_llm.py)"
UNIT, MOVES, SOURCE = "ms", "request_ms_p95", "program_span"


def read(r):
    return spans.stage_ms(r, "llm")
