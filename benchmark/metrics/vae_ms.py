"""Eager CUDA-event ms of decode_latent (the VAE1D decoder) for one request
at the traced stretch's longest mel length, after a warm-up call. Eager: a
stage inside a replayed graph cannot be timed from outside."""

LAYER = "VAE (models/vae1d.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "device_trace"


def read(r):
    return None if r.stages_ms is None else r.stages_ms["vae"]
