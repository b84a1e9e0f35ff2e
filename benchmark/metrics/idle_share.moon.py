"""1 - device busy / wall over the traced stretch of the caption-LLM cell,
both on the profiler's clock: busy is the union of every device event
(kernels, copies, sets). How far the host holds back a request of ~85
small launches a tower layer."""

LAYER = "device (torch.profiler over a traced stretch)"
UNIT, MOVES, SOURCE = "%", "request_ms_p95", "device_trace"


def read(r):
    return None if r.trace is None else 100.0 * r.trace.idle_share
