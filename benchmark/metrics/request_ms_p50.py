"""Median host-clock latency of all of the window's requests: the call
to the waveform in host memory. Reported beside the tail, without a bound:
it moves with the host's cost of launching a replayed graph, which is set
per process (two modes 2 % apart), so runs of one tree split into two
groups that no bound on it can hold."""

import statistics

LAYER = "serving graphs (aot.CapturedGenerate, api.prewarm_buckets)"
UNIT, MOVES, SOURCE = "ms", "request_ms_p95", "host_clock"


def read(r):
    return 1e3 * statistics.median(s for _, s in r.records)
