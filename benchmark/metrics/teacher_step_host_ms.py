"""Median host ms of one DDIM step of the teacher (the program's
`ddim.step` span: the host's issue of the step, no sync) over the window's
requests, which run without the profiler."""

from benchmark.harness import spans

LAYER = "sampler and denoiser (diffusion/lcm.py, diffusion/ddim.py, models/dit.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "program_span"


def read(r):
    return spans.host_ms_median(r, "ddim.step")
