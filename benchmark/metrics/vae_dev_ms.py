"""Device ms of the VAE decode (the `vae` stage: decode_latent) per window
request, from the program's own device stamps, taken inside the replayed
graph (`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "VAE (models/vae1d.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "program_span"


def read(r):
    return spans.stage_ms(r, "vae")
