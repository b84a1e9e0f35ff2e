"""Eager CUDA-event ms of sample_latent / sample_latent_teacher (the
sampler's DiT forwards) for one request at the traced stretch's longest
mel length, after a warm-up call. Eager: a stage inside a replayed graph
cannot be timed from outside."""

LAYER = "sampler and denoiser (diffusion/lcm.py, diffusion/ddim.py, models/dit.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "device_trace"


def read(r):
    return None if r.stages_ms is None else r.stages_ms["dit"]
