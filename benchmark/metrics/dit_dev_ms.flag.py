"""Device ms of the Flag-DiT teacher's sampler and denoiser (the `dit`
stage of `sample_latent_teacher`: 100 DDIM steps, each one
TxtFlagLargeDiT forward at the guidance-doubled batch) per window request,
from the program's own device stamps (`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "sampler and denoiser (diffusion/lcm.py, diffusion/ddim.py, models/dit.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "program_span"


def read(r):
    return spans.stage_ms(r, "dit")
