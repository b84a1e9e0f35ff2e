"""Seconds of audio delivered by the window's requests, all clips, over
the window's seconds (host clock; the window ends with its last request)."""

LAYER, UNIT, MOVES, SOURCE = "end to end", "s/s", None, "host_clock"


def read(r):
    return sum(req.audio_s for req, _ in r.records) / r.window_s
