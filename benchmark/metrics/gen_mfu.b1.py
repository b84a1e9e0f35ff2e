"""The whole generate's share of the bf16 peak: the FLOP of every request
of the window (harness.work.request_flop: the model's matrix products and
convolutions at the request's shapes) over the window's seconds and the
card's published 989 TFLOP/s."""

from benchmark.harness import work

LAYER = "whole generate (pipeline.AudioLCMPipeline)"
UNIT, MOVES, SOURCE = "%", "request_ms_p95", "host_clock"


def read(r):
    flop = sum(work.request_flop(r.config, q.batch, q.mel_len, r.traffic["tokens"])
               for q, _ in r.records)
    return 100.0 * flop / r.window_s / work.PEAKS[r.config["serving"]["compute_dtype"]]
