"""K7 launches per window request: the program's `moe_experts` counter,
four per expert layer (dispatch, gate-up, down, combine; 26 layers). None where the
program has no K7 (`COUNTER` in `audiolcm_torch/nn/moe_experts.py`)."""

from benchmark.harness import spans

LAYER = "K7 (nn/moe_experts.py)"
UNIT, MOVES, SOURCE = "count", "request_ms_p95", "program_counter"


def read(r):
    try:
        from audiolcm_torch.nn.moe_experts import COUNTER
    except ImportError:
        return None
    return spans.launches(r, COUNTER)
