"""Device ms of the vocoder (the `vocoder` stage) of the window's requests
of the longest class (20 s, mel 1248), the class that sets the p95, from
the program's own device stamps inside the replayed graph
(`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "vocoder (models/bigvgan.py)"
UNIT, MOVES, SOURCE = "ms", "request_ms_p95", "program_span"


def read(r):
    return spans.stage_ms(r, "vocoder", mel_len=max(r.traffic["mel_lens"]))
