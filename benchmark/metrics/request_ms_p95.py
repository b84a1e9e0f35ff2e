"""95th percentile (inclusive interpolation) of the host-clock latency of
all of the window's requests."""

import statistics

LAYER, UNIT, MOVES, SOURCE = "end to end", "ms", None, "host_clock"


def read(r):
    return 1e3 * statistics.quantiles([s for _, s in r.records], n=20, method="inclusive")[18]
