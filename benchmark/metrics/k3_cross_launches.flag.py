"""K3 launches whose keys are not the queries' sequence, per window
request: the program's `flash_attention.cross` counter, one per caption
branch of every Flag-DiT block (24 blocks x 100 DDIM steps). None where
the program's K3 has no such counter (`CROSS_COUNTER` in
`audiolcm_torch/nn/flash_attention.py`)."""

from benchmark.harness import spans

LAYER = "K3 (nn/flash_attention.py, csrc/flash_attention.cu)"
UNIT, MOVES, SOURCE = "count", "audio_s_per_s", "program_counter"


def read(r):
    try:
        from audiolcm_torch.nn.flash_attention import CROSS_COUNTER
    except ImportError:
        return None
    return spans.launches(r, CROSS_COUNTER)
