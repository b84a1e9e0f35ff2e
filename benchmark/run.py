#!/usr/bin/env python3
"""One run of one cell of the audiolcm_torch benchmark, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 benchmark/run.py --workload <cell> --seed <n> --seconds 1 --trace 0 --rehearsal

A run builds the cell's pipeline from the seed (weights drawn on the card),
captures and warms the cell's own shapes (set-up), then sends the cell's
traffic for `--seconds` through the loop its mix names
(`benchmark/loops/<loop>.py`; a mix that asks for what its loop does not
run is refused before set-up): every metric is over all of the window's
requests and all of its time. With `--trace 1` a traced stretch
of further requests, and eager CUDA-event timings of each stage, follow the
window, and the result carries the per-layer metrics instead of the
end-to-end ones. Then the program is freed and the plain reference checks
a sample of the window's outputs (`harness/check.py`).

The last line of standard output is the result (JSON); the last lines of
standard error are the numbers compared, each beside its limit. With no
card, or fewer than the cell asks for, the run exits 3 and prints no
result. `--rehearsal` runs the same flow on the CPU at tiny widths and
prints `{"rehearsal": true, ...}`, never a metric.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the port imports no JAX; keep transformers, should anything load it, from loading it
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "audiolcm_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Readings:
    """What the metric readers (`benchmark/metrics/<name>.py`) read."""

    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    records: list  # (request, seconds) of every request of the window
    capture_s: list
    trace: Optional[object] = None  # harness.trace.Trace of the traced stretch
    traced: list = dataclasses.field(default_factory=list)  # its requests
    stages_ms: Optional[dict] = None  # eager CUDA-event ms per stage


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearsal", action="store_true",
                   help="the CPU rehearsal at tiny widths; prints no metric")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    # one host thread: the host's share of a request is launches and copies,
    # and idle worker threads only contend with them on a shared machine
    torch.set_num_threads(1)
    from benchmark.harness import check, spec, traffic as traffic_mod
    from benchmark.reference import ops

    cell = spec.load_cell(args.workload)
    if args.rehearsal:
        from benchmark.harness.rehearsal import tiny

        cell.config, cell.traffic = tiny(cell.config, cell.traffic)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"no result: cell {cell.name} needs {cell.chips} CUDA device(s); "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda:0")
    mix = cell.traffic
    loop = spec.load_loop(mix)
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}").Driver(
        cell, args.seed, device)
    warm = [dataclasses.replace(traffic_mod.request(mix, cell.config, args.seed, -1 - i),
                                mel_len=m) for i, m in enumerate(sorted(set(mix["mel_lens"])))]
    driver.setup(warm)
    sync = (lambda: torch.cuda.synchronize()) if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - T_START

    records, window_s = loop.run(driver, traffic_mod.requests(mix, cell.config, args.seed),
                                 args.seconds)
    log(f"window: {len(records)} requests in {window_s:.3f} s; set-up {setup_s:.3f} s")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    readings = Readings(cell.config, mix, setup_s, window_s, [(r, s) for r, s, _ in records],
                        driver.capture_s)

    if args.trace and not args.rehearsal:
        from torch.profiler import record_function

        from benchmark.harness.trace import traced

        n_traced = cell.check["trace_requests"]
        more = traffic_mod.requests(mix, cell.config, args.seed, start=len(records))
        readings.traced = [next(more) for _ in range(n_traced)]

        class Spanned:  # the driver, each request inside a profiler range
            def run(self, req):
                with record_function("bench.request"):
                    return driver.run(req)

        def stretch():
            return len(loop.run(Spanned(), iter(readings.traced), math.inf)[0])

        readings.trace = traced(stretch)
        longest = max(readings.traced, key=lambda r: r.mel_len)
        readings.stages_ms = driver.stage_ms(longest)
        t = readings.trace
        log(f"stages (eager, one request at mel {longest.mel_len}): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in readings.stages_ms.items())
            + f"; sum {sum(readings.stages_ms.values()):.3f} ms; traced stretch: device busy "
            f"{1e3 * t.busy_s / t.requests:.3f} ms per request, "
            f"{1e3 * t.window_s / t.requests:.3f} ms of window per request")

    failed = sum(1 for _, _, (wav, _) in records if not bool(torch.isfinite(wav).all()))
    sample = check.pick_sample(records, args.seed, cell.check["sample"])
    del records
    driver.free_program()
    ref_t0 = time.perf_counter()
    numbers = check.compare(sample, lambda r: driver.reference(r, ops.F32))
    limits = cell.check["limits"]
    correct = check.judge(numbers, limits) and failed == 0
    log(f"reference: {len(sample)} requests in {time.perf_counter() - ref_t0:.1f} s")

    found = forbidden_modules()
    if found:
        log(f"no result: JAX or the JAX package loaded in this process: {found}")
        return 4
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result = {"correct": correct, "attempted": len(readings.records), "failed": failed}
    if args.rehearsal:
        result = {"rehearsal": True, **result}
    else:
        metrics = {}
        for m in cell.metrics(bool(args.trace)):
            value = spec.load_metric(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": cell.chips, "memory_peak_bytes": memory_peak}
        if readings.trace is not None:
            result["device"].update(busy_s=readings.trace.busy_s,
                                    window_s=readings.trace.window_s)
            result["breakdown"] = {"device_ops": readings.trace.top_ops(10),
                                   "idle_gaps": [list(g) for g in readings.trace.gaps]}
        result["card"] = card_line()
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


if __name__ == "__main__":
    sys.exit(main())
