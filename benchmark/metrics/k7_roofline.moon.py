"""K7's share of its roofline: its least time over every traced request's
tower forward (harness.work_moe.k7_bound_s: the larger of every routed
expert's weights and the tokens' activations at 3.35 TB/s and the routed
FLOP at 989 TFLOP/s) over the device time of all of K7's kernels (every
kernel whose name starts with `k7_`: the dispatch, gate-up, down and the
combine) in the traced stretch. None where no such kernel ran."""

from benchmark.harness import work_moe

LAYER = "K7 (nn/moe_experts.py)"
UNIT, MOVES, SOURCE = "%", "request_ms_p95", "device_trace"
PREFIX = "k7_"


def read(r):
    if r.trace is None:
        return None
    seconds = sum(e - s for name, s, e in r.trace.ops if name.startswith(PREFIX))
    if seconds <= 0:
        return None
    bound = sum(work_moe.k7_bound_s(r.config, q.batch * r.traffic["llm_tokens"])
                for q in r.traced)
    return 100.0 * bound / seconds
