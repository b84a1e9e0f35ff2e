"""The closed loop (`"loop": "closed"` in a mix): one client sends a
request, waits until its output is in host memory, then sends the next.
It runs `"clients": 1` and refuses a mix that asks for more."""

from __future__ import annotations

import time


def check(mix: dict) -> None:
    """Raises where the mix asks for what this loop does not run."""
    if mix.get("clients") != 1:
        raise ValueError(f"loop 'closed' runs one client; the mix asks for "
                         f"{mix.get('clients')!r}")


def run(driver, requests, seconds: float):
    """Sends `requests` one after another until `seconds` have passed since
    the first was sent (the request in flight then finishes) or they run
    out -> ([(request, latency seconds, output)], window seconds)."""
    records = []
    start = end = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        out = driver.run(req)
        end = time.perf_counter()
        records.append((req, end - t0, out))
        if end - start >= seconds:
            break
    return records, end - start
