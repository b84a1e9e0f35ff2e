"""The Flag-DiT teacher's share of the bf16 peak: the FLOP of every
request of the window (harness.work_flagdit.request_flop: the text towers,
100 guidance-doubled TxtFlagLargeDiT forwards with the caption's part once,
the VAE and the vocoder at the request's shapes) over the window's seconds and the card's published
989 TFLOP/s."""

from benchmark.harness import work, work_flagdit

LAYER = "whole generate (pipeline.AudioLCMPipeline)"
UNIT, MOVES, SOURCE = "%", "audio_s_per_s", "host_clock"


def read(r):
    flop = sum(work_flagdit.request_flop(r.config, q.batch, q.mel_len, r.traffic["tokens"])
               for q, _ in r.records)
    return 100.0 * flop / r.window_s / work.PEAKS[r.config["serving"]["compute_dtype"]]
