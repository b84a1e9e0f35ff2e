"""Median host ms of `CUDAGraph.replay()` (the program's `replay.launch`
span) over the window's requests, which run without the profiler: the
host's launch of a replayed graph, while the card waits for it."""

from benchmark.harness import spans

LAYER = "serving graphs (aot.CapturedGenerate, api.prewarm_buckets)"
UNIT, MOVES, SOURCE = "ms", "request_ms_p95", "program_span"


def read(r):
    return spans.host_ms_median(r, "replay.launch")
