"""K6's share of its roofline: the FLOP of the resblock convs K6 runs (every
vocoder stage wider than the configuration's `pallas_stage_max_channels`:
2 x 2 x len(dilations) x sum(kernel sizes) x C^2 FLOP per sample, 252 C^2
at (3, 7, 11) x (1, 3, 5), for every traced request) at the bf16 peak, over
the device time of the kernels named `wide_conv*` in the traced stretch.
No byte term: a C = 96 stage's input can sit in the 50 MB L2, so a bound
on HBM bytes could read above 100 %. None where no such kernel ran (a
program without K6)."""

from benchmark.harness import work

LAYER = "K6 (nn/wide_conv.py, csrc/wide_conv.cu)"
UNIT, MOVES, SOURCE = "%", "audio_s_per_s", "device_trace"
KERNELS = ("wide_conv",)


def convs_flop(config: dict, batch: int, mel_len: int) -> float:
    """The resblock convs of one request's unfused stages."""
    cmax = config["serving"]["pallas_stage_max_channels"]
    c = config["vocoder"]
    per_c2 = 2 * 2 * len(c["resblock_dilation_sizes"][0]) * sum(c["resblock_kernel_sizes"])
    return sum(per_c2 * ch * ch * batch * t
               for ch, t in work.vocoder_stages(c, mel_len) if ch > cmax)


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.seconds_of(*KERNELS)
    if seconds <= 0:
        return None
    flop = sum(convs_flop(r.config, q.batch, q.mel_len) for q in r.traced)
    return 100.0 * flop / work.PEAKS["bfloat16"] / seconds
