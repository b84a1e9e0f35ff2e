"""K3's share of its roofline in the Flag-DiT teacher: the least time of
every self-attention and caption cross-attention of the traced requests
(harness.work_flagdit.attention_bound_s) over the device time of the flash
kernels in the traced stretch."""

from benchmark.harness import work_flagdit

LAYER = "K3 (nn/flash_attention.py, csrc/flash_attention.cu)"
UNIT, MOVES, SOURCE = "%", "audio_s_per_s", "device_trace"
KERNELS = ("flash_attention_tc_kernel", "flash_attention_f32_kernel")


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.seconds_of(*KERNELS)
    if seconds <= 0:
        return None
    bound = sum(work_flagdit.attention_bound_s(r.config, q.batch, q.mel_len,
                                               r.traffic["tokens"]) for q in r.traced)
    return 100.0 * bound / seconds
