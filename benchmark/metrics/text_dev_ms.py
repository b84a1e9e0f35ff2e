"""Device ms of the text towers (the `text` stage: encode_text_ids) per
window request, from the program's own device stamps, taken inside the
replayed graph (`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "text towers (models/clap_text.py, models/t5_encoder.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "program_span"


def read(r):
    return spans.stage_ms(r, "text")
