"""The program's own recorder (`audiolcm_torch.obs`) as the per-layer
readers see it; the one place they reach `obs.snapshot()`.

The window's requests are picked by the recorder's request ids: a run opens
one request per generate call, first the warm ones (one per mel length of
the mix), then the window's (`readings.records`), then the traced
stretch's (`readings.traced`), so the window is the run of ids that ends
where the traced stretch begins. Every function returns None where the
recorder is missing (a program without `obs`) or lacks any of what it
reads (a request, a stage, a device time).
"""

from __future__ import annotations

import statistics
from typing import Optional


def snapshot() -> Optional[dict]:
    try:
        from audiolcm_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def window(r, snap: Optional[dict] = None) -> Optional[list]:
    """[(request, its root span, the other spans of the request)] of every
    request of the window, in order, or None."""
    snap = snapshot() if snap is None else snap
    if snap is None:
        return None
    n_warm = len(set(r.traffic["mel_lens"]))
    first = snap["requests"] - len(r.traced) - len(r.records)
    if first < n_warm or not r.records:
        return None
    spans: dict = {}
    for s in snap["spans"]:
        if s["request"] is not None and first <= s["request"] < first + len(r.records):
            spans.setdefault(s["request"], []).append(s)
    out = []
    for i, (req, _) in enumerate(r.records):
        mine = spans.get(first + i, [])
        root = [s for s in mine if s["name"] == "request"]
        if not root:
            return None
        out.append((req, root[0], [s for s in mine if s["name"] != "request"]))
    return out


def device_ms(r, keep, mel_len: Optional[int] = None) -> Optional[float]:
    """Mean over the window's requests (those of `mel_len`, when given) of
    the device ms of their stages for which keep(span) holds; None where a
    request has no such stage or one lacks its device time."""
    reqs = window(r)
    if reqs is None:
        return None
    per_request = []
    for req, _, spans in reqs:
        if mel_len is not None and req.mel_len != mel_len:
            continue
        times = [s["device_ms"] for s in spans if keep(s)]
        if not times or any(t is None for t in times):
            return None
        per_request.append(sum(times))
    return statistics.fmean(per_request) if per_request else None


def stage_ms(r, name: str, mel_len: Optional[int] = None) -> Optional[float]:
    """Device ms per window request of the stage `name`."""
    return device_ms(r, lambda s: s["name"] == name, mel_len)


def host_ms_median(r, name: str) -> Optional[float]:
    """Median host ms of the spans `name` of the window's requests."""
    reqs = window(r)
    if reqs is None:
        return None
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for _, _, spans in reqs for s in spans
          if s["name"] == name]
    return statistics.median(ms) if ms else None


def launches(r, key: str) -> Optional[float]:
    """Launches of kernel counter `key` per window request."""
    reqs = window(r)
    if reqs is None:
        return None
    return statistics.fmean(root["counts"].get(key, 0) for _, root, _ in reqs)


def init_s(r) -> Optional[float]:
    """Seconds of the last `init` span (AudioLCMPipeline.__init__) that
    ended before the window's first request began."""
    snap = snapshot()
    reqs = window(r, snap)
    if reqs is None:
        return None
    begin = reqs[0][1]["start_ns"]
    inits = [s for s in snap["spans"] if s["name"] == "init" and s["end_ns"] is not None
             and s["end_ns"] <= begin]
    return (inits[-1]["end_ns"] - inits[-1]["start_ns"]) / 1e9 if inits else None
