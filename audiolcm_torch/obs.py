"""The port's recorder: host spans, device times of the generate's stages
(also inside replayed CUDA graphs), and kernel launch counters.

Always on; a request costs microseconds and nothing leaves the process
until `snapshot()` is called. It opens no torch.profiler range.

Spans. A span has a name, host start and end stamps, its parent span, the
request it belongs to and attributes. Host stamps are integer nanoseconds
on the clock torch.profiler stamps its host events with (Unix time, as
kineto's `start_ns()`): `time.perf_counter_ns()` plus one offset fixed at
import, so durations are monotonic. Spans live in a ring of `RING_SPANS`
that counts what it drops. The names:

- `request` (attribute `kind`: `replay`, `eager` or `teacher`): the root of
  each `AudioLCMPipeline.generate` / `generate_teacher` call, with the
  launch counts of that call (`counts`);
- `text`, `llm` (the optional caption LLM, after `text`), `dit`, `vae`,
  `vocoder`, `vocoder.stage<i>` (attributes `C` and `fused`): the
  generate's stages (`stage`). Inside a request, or a graph
  capture, on a CUDA device a stage also takes its device time
  (`device_ms`) from two stamps of the card's nanosecond timer, written by
  a one-thread kernel (`csrc/stamp.cu`) on the current stream into a ring
  on the device (`RING_STAMPS` per device). A stage that opens right after
  its previous sibling closed starts at that sibling's end stamp: the
  port's generate issues no device work between sibling stages, so a
  replay of ten stages runs twelve stamps. Captured, the stamps are kernel
  nodes of the graph, so every replay stamps its own stages into the next
  slots: the replay's request gets one span per captured stage, with no
  host stamps. The host reads the ring at `snapshot()` only (one sync);
  a stage whose slots the ring has since reused reads None and counts as
  `lost`. On the CPU stages are host spans only;
- `replay.launch`: the host's `CUDAGraph.replay()` call;
- `ddim.step`: the host's issue of one DDIM step, with no sync;
- `init`: `AudioLCMPipeline.__init__`; `capture`: one `CapturedGenerate`
  built (its warm-up run and the capture).

Counters (`count`), keyed by kernel and route: `amp_stage.mma`,
`amp_stage.f32`, `flash_attention.tc`, `flash_attention.f32`, `act_chain`,
`alias_free_act`, `wide_conv`, `moe_experts` (K7, four per expert layer);
and `flash_attention.cross`, which counts again each K3
launch whose keys number other than its queries (the Flag DiT's caption
branch). A launch made while a graph captures (`capture()`) goes
to the graph's `Tally`, which `launch()` adds to the totals once per
replay, so a counter counts what ran. The recorder serves one host thread.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import time
from typing import Optional

import torch

RING_SPANS = 1 << 15  # 2.4x the longest run's spans: ~1120 batch-1 replays of 12 spans
RING_STAMPS = 1 << 16  # per device: 3200 replays of 10 stages

_EPOCH_NS = time.time_ns() - time.perf_counter_ns()
_ring: collections.deque = collections.deque(maxlen=RING_SPANS)
_ids = itertools.count()
_recorded = 0  # spans ever put in the ring
_stack: list = []  # the open host spans, innermost last
_request: Optional["Span"] = None  # the open request span
_requests = 0  # requests opened so far; the next request's id
_counts: dict = {}
_capture: Optional["Tally"] = None  # the graph being captured
_stamp_rings: dict = {}  # device index -> _Stamps
# the stage that closed last: (its span's parent, its stamp ring, its end slot)
_last_stage: Optional[tuple] = None
# timed stages whose stamps are still to be read, by request or replay:
# (stamps, base slot, [span], [(start, end) slots from the base])
_pending: collections.deque = collections.deque(maxlen=RING_STAMPS // 2)
_lost = 0  # timed stages whose stamps were overwritten before they were read


def _now_ns() -> int:
    return time.perf_counter_ns() + _EPOCH_NS


class Span:
    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "request", "attrs", "device_ms")

    def __init__(self, name: str, parent, request, attrs, start_ns):
        self.id, self.name, self.parent, self.request = next(_ids), name, parent, request
        self.attrs, self.start_ns, self.end_ns, self.device_ms = attrs, start_ns, None, None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "parent": self.parent, "request": self.request,
                "device_ms": self.device_ms, **(self.attrs or {})}


def _put(span: Span) -> Span:
    global _recorded
    _ring.append(span)
    _recorded += 1
    return span


def _open(name: str, attrs=None) -> Span:
    span = _put(Span(name, _stack[-1].id if _stack else None,
                     None if _request is None else _request.request, attrs, _now_ns()))
    _stack.append(span)
    return span


def _close(span: Span) -> None:
    span.end_ns = _now_ns()
    _stack.pop()


class _Host:
    __slots__ = ("name", "attrs", "span")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        self.span = _open(self.name, self.attrs)
        return self.span

    def __exit__(self, *exc) -> None:
        _close(self.span)


def span(name: str, **attrs) -> _Host:
    """A host span around the `with` block."""
    return _Host(name, attrs or None)


class _Request:
    __slots__ = ("kind", "span", "before")

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self) -> Optional[Span]:
        global _request, _requests
        if _request is not None:  # a request inside a request is part of it
            self.span = None
            return None
        self.before = dict(_counts)
        self.span = _request = _open("request", {"kind": self.kind})
        _request.request, _requests = _requests, _requests + 1
        return _request

    def __exit__(self, *exc) -> None:
        global _request
        if self.span is None:
            return
        before = self.before
        self.span.attrs["counts"] = {k: v - before.get(k, 0) for k, v in _counts.items()
                                     if v != before.get(k, 0)}
        _close(self.span)
        _request = None


def request(kind: str) -> _Request:
    """The root span of one generate call (`kind`: replay, eager, teacher).
    Inside an open request it opens nothing."""
    return _Request(kind)


# ------------------------------------------------------------------ device stamps

class _Stamps:
    """The stamp ring of one CUDA device and the host's count of the stamps
    issued to it (the device's head, once they have run)."""

    def __init__(self, device: torch.device):
        from audiolcm_torch.build import build

        self.device = device
        self.ring = torch.zeros(RING_STAMPS, dtype=torch.int64, device=device)
        self.head = torch.zeros(1, dtype=torch.int64, device=device)
        self.issued = 0
        lib = ctypes.CDLL(str(build("stamp")))
        lib.stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p]
        lib.stamp_launch.restype = ctypes.c_int
        self._lib = lib  # keeps the library loaded
        self._args = (self.ring.data_ptr(), self.head.data_ptr(), RING_STAMPS - 1)

    def stamp(self) -> int:
        """Stamps the current stream; -> the stamp's slot number."""
        with torch.cuda.device(self.device):
            rc = self._lib.stamp_launch(*self._args,
                                        torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"stamp kernel launch failed: CUDA error {rc}")
        self.issued += 1
        return self.issued - 1

    def times(self) -> list:
        """The ring's stamps (ns) after the device has run every stamp."""
        torch.cuda.synchronize(self.device)
        return self.ring.tolist()


def _stamps_for(device: torch.device) -> Optional[_Stamps]:
    """The stamp ring that times stages on `device`, or None (the CPU)."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    ring = _stamp_rings.get(index)
    if ring is None:
        ring = _stamp_rings[index] = _Stamps(torch.device("cuda", index))
    return ring


class Tally:
    """What one graph capture recorded: the launches counted while it
    captured, its stamp ring and stamps per replay (`n_stamps`), and its
    stages as (name, attributes, index of the enclosing stage or -1) with
    their (start, end) stamps as offsets into a replay's (`slots`)."""

    def __init__(self, stamps: Optional[_Stamps]):
        self.counts: dict = {}
        self.stamps, self.n_stamps = stamps, 0
        self.base = stamps.issued if stamps is not None else 0
        self.stages: list = []
        self.slots: list = []
        self.open: list = []  # indices of the stages open during the capture


class _Capture:
    __slots__ = ("device", "tally")

    def __init__(self, device):
        self.device = device

    def __enter__(self) -> Tally:
        global _capture
        self.tally = _capture = Tally(_stamps_for(self.device))
        return self.tally

    def __exit__(self, *exc) -> None:
        global _capture
        tally, _capture = self.tally, None
        if tally.stamps is not None:  # the captured stamps run at each replay, not now
            tally.n_stamps = tally.stamps.issued - tally.base
            tally.stamps.issued = tally.base


def capture(device: torch.device) -> _Capture:
    """Around a CUDA graph capture on `device` (entered before the capture
    begins, so that the stamp ring is not allocated from the graph's pool):
    its launches and stages go to the returned Tally."""
    return _Capture(device)


class _Stage:
    __slots__ = ("name", "device", "attrs", "host", "stamps", "start")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self) -> Span:
        self.host = _open(self.name, self.attrs)
        self.stamps = None
        if _capture is not None or _request is not None:
            self.stamps = _stamps_for(self.device)
            if self.stamps is not None:
                last = _last_stage
                if (last is not None and last[0] == self.host.parent and last[1] is self.stamps
                        and last[2] == self.stamps.issued - 1):
                    self.start = last[2]  # its previous sibling's end: nothing ran between
                else:
                    self.start = self.stamps.stamp()
                if _capture is not None:
                    _capture.open.append(len(_capture.stages))
                    _capture.stages.append(None)  # filled when the stage closes
                    _capture.slots.append(None)
        return self.host

    def __exit__(self, *exc) -> None:
        global _last_stage
        if self.stamps is not None:
            end = self.stamps.stamp()
            _last_stage = (self.host.parent, self.stamps, end)
            if _capture is not None:
                i = _capture.open.pop()
                _capture.stages[i] = (self.name, self.attrs,
                                      _capture.open[-1] if _capture.open else -1)
                _capture.slots[i] = (self.start - _capture.base, end - _capture.base)
            else:
                _defer(self.stamps, 0, (self.host,), ((self.start, end),))
        _close(self.host)


def _defer(stamps: _Stamps, base: int, spans, slots) -> None:
    """Leaves the device times of `spans` to be read from their stamps."""
    global _lost
    if len(_pending) == _pending.maxlen:
        _lost += len(_pending[0][2])
    _pending.append((stamps, base, spans, slots))


def stage(name: str, device: torch.device, **attrs) -> _Stage:
    """A host span around the `with` block; on a CUDA device, inside a
    request or a graph capture, also its device time."""
    return _Stage(name, device, attrs or None)


# ------------------------------------------------------------------ counters and replays

def count(key: str, n: int = 1) -> None:
    """n launches of kernel `key`: to the capturing graph's tally during a
    capture, else to the totals."""
    into = _counts if _capture is None else _capture.counts
    into[key] = into.get(key, 0) + n


def counters() -> dict:
    """A copy of the launch totals."""
    return dict(_counts)


class _Launch:
    __slots__ = ("tally", "host")

    def __init__(self, tally):
        self.tally = tally

    def __enter__(self) -> Span:
        self.host = _open("replay.launch")
        return self.host

    def __exit__(self, *exc) -> None:
        _close(self.host)
        tally = self.tally
        for k, v in tally.counts.items():
            _counts[k] = _counts.get(k, 0) + v
        if tally.n_stamps == 0:
            return
        stamps = tally.stamps
        base, stamps.issued = stamps.issued, stamps.issued + tally.n_stamps
        root, rid, spans = self.host.parent, self.host.request, []
        for name, attrs, parent in tally.stages:
            spans.append(_put(Span(name, root if parent < 0 else spans[parent].id, rid, attrs,
                                   None)))
        _defer(stamps, base, spans, tally.slots)


def launch(tally: Tally) -> _Launch:
    """The `replay.launch` span around `CUDAGraph.replay()` of the graph
    whose capture recorded `tally`: adds its launches to the totals and
    gives the open request one span per captured stage, timed by this
    replay's stamps."""
    return _Launch(tally)


# ------------------------------------------------------------------ reading

def _read() -> None:
    """Fills the device times of every pending stage (a sync per device)."""
    global _lost
    times = {}
    for stamps, base, spans, slots in _pending:
        t = times.get(id(stamps))
        if t is None:
            t = times[id(stamps)] = stamps.times()
        for span_, (start, end) in zip(spans, slots):
            if stamps.issued - (base + start) > RING_STAMPS:
                _lost += 1
            else:
                span_.device_ms = (t[(base + end) % RING_STAMPS]
                                   - t[(base + start) % RING_STAMPS]) / 1e6
    _pending.clear()


def snapshot() -> dict:
    """Everything recorded: the spans in the ring, oldest first, with their
    stages' device times read; the launch totals; the number of requests
    opened; the spans dropped from the ring; and the timed stages lost to
    the stamp ring's reuse."""
    _read()
    return {"spans": [s.as_dict() for s in _ring], "counters": dict(_counts),
            "requests": _requests, "dropped": _recorded - len(_ring), "lost": _lost,
            "clock": "unix_ns"}


def reset() -> None:
    """Forgets every span, count and pending stage (open spans too); the
    stamp rings and captured graphs stay valid."""
    global _recorded, _request, _requests, _capture, _lost, _last_stage
    _ring.clear()
    _stack.clear()
    _counts.clear()
    _pending.clear()
    _recorded, _request, _requests, _capture, _lost, _last_stage = 0, None, 0, None, 0, None
