"""Device ms per window request of the vocoder's upsample stages that ran
unfused (`vocoder.stage<i>` with `fused` false: C = 768..96 in the
serving profile, where K1 has no tile), from the program's own device
stamps inside the replayed graph (`audiolcm_torch.obs`)."""

from benchmark.harness import spans

LAYER = "vocoder (models/bigvgan.py)"
UNIT, MOVES, SOURCE = "ms", "audio_s_per_s", "program_span"


def read(r):
    return spans.device_ms(r, lambda s: s["name"].startswith("vocoder.stage")
                           and s.get("fused") is False)
