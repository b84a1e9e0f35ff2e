"""1 - device busy / wall over the traced stretch, both on the profiler's
clock: busy is the union of every device event (kernels, copies, sets)."""

LAYER = "device (torch.profiler over a traced stretch)"
UNIT, MOVES, SOURCE = "%", "audio_s_per_s", "device_trace"


def read(r):
    return None if r.trace is None else 100.0 * r.trace.idle_share
