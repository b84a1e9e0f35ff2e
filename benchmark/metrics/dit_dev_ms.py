"""Device ms of the sampler and its DiT forwards (the `dit` stage:
sample_latent in the replayed graph, sample_latent_teacher on the teacher
path) per window request, from the program's own device stamps
(`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "sampler and denoiser (diffusion/lcm.py, diffusion/ddim.py, models/dit.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "program_span"


def read(r):
    return spans.stage_ms(r, "dit")
