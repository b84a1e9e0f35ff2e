"""Reduction of one traced stretch (torch.profiler, CPU + CUDA activities)
to what the per-layer readers and the result's `device` and `breakdown`
need: device busy seconds (the union of every device event's interval:
kernels, copies, sets), the stretch's length on the same clock, device
seconds by kernel name, the longest idle gaps with the innermost host
operation that covers each, and the requests in the stretch."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Tuple

import torch

WINDOW = "bench.traced_window"


@dataclasses.dataclass
class Trace:
    requests: int
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]  # device events: (name, start_s, end_s)
    gaps: List[Tuple[str, float]]  # the longest idle gaps: (host op, seconds)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def seconds_of(self, *substrings: str) -> float:
        """Device seconds of the events whose name holds any of `substrings`."""
        return sum(e - s for n, s, e in self.ops if any(x in n for x in substrings))

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: dict = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def traced(run: Callable[[], int], n_gaps: int = 10) -> Trace:
    """Profile run() (which returns its request count) in one window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            n = run()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = next(e for e in events if e.name == WINDOW and e.device_type != cuda)
    w0, w1 = window.time_range.start, window.time_range.end
    # device events: kernels, copies, sets; not the device-side copies of the
    # harness's own record_function ranges ("bench.*")
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda and e.time_range.end > e.time_range.start
           and not e.name.startswith("bench.")]
    dev = [(n_, max(s, w0), min(e, w1)) for n_, s, e in dev if e > w0 and s < w1]
    busy = _union((s, e) for _, s, e in dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    host = [e for e in events if e.device_type != cuda and e.name != WINDOW]
    labelled = []
    for length, s, e in gaps[:n_gaps]:
        mid = (s + e) / 2
        cover = [h for h in host if h.time_range.start <= mid <= h.time_range.end]
        name = min(cover, key=lambda h: h.time_range.end - h.time_range.start).name \
            if cover else "host (no traced op)"
        labelled.append((name, length / 1e6))
    us = 1e-6
    out = Trace(requests=n, window_s=(w1 - w0) * us, busy_s=sum(e - s for s, e in busy) * us,
                ops=[(n_, s * us, e * us) for n_, s, e in dev], gaps=labelled)
    print(f"trace: {len(events)} events reduced in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return out
