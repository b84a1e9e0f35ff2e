"""K1's share of its roofline: the least time of the fused vocoder stages'
work (harness.work.fused_stages_bound_s, for every traced request) over the
device time of the kernels that compute those stages in the traced
stretch (`amp_stage_mma_kernel`, the bf16 tensor-core route)."""

from benchmark.harness import work

LAYER = "K1 (nn/amp_stage.py, csrc/amp_stage.cu)"
UNIT, MOVES, SOURCE = "%", "audio_s_per_s", "device_trace"
KERNELS = ("amp_stage_mma_kernel",)


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.seconds_of(*KERNELS)
    if seconds <= 0:
        return None
    bound = sum(work.fused_stages_bound_s(r.config, q.batch, q.mel_len) for q in r.traced)
    return 100.0 * bound / seconds
