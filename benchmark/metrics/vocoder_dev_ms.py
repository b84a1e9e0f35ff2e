"""Device ms of the vocoder (the `vocoder` stage: vocode, BigVGAN) per
window request, from the program's own device stamps, taken inside the
replayed graph on the LCM path (`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "vocoder (models/bigvgan.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "program_span"


def read(r):
    return spans.stage_ms(r, "vocoder")
