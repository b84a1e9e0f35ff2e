"""The caption-LLM generate's share of the bf16 peak: the FLOP of every
request of the window (harness.work_moe.request_flop: CLAP and T5, the
Moonlight tower, the two LCM steps' DiT over 282 condition tokens, the VAE
and the vocoder at the request's shapes) over the window's seconds and the
card's published 989 TFLOP/s."""

from benchmark.harness import work, work_moe

LAYER = "whole generate (pipeline.AudioLCMPipeline)"
UNIT, MOVES, SOURCE = "%", "request_ms_p95", "host_clock"


def read(r):
    flop = sum(work_moe.request_flop(r.config, q.batch, q.mel_len, r.traffic["tokens"],
                                     r.traffic["llm_tokens"]) for q, _ in r.records)
    return 100.0 * flop / r.window_s / work.PEAKS[r.config["serving"]["compute_dtype"]]
