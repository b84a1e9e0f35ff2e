#!/usr/bin/env python3
"""The control's readings, the upper ends that a cell's correctness limits
are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--rehearsal]

For each seed: the cell's weights, and a sample of the cell's requests as
large as a run compares, drawn as a run draws it; then the control, the
plain reference computed with fp8 operands (`reference.ops.Precision("fp8")`,
one precision below the bfloat16 the configurations state) in the
program's place, held by `harness/check.py` against the same reference in
float32. Prints one JSON line per seed with the numbers and the cell's
limits. The lower ends are the program's own numbers, which every run of
`run.py` prints beside their limits. Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_readings(cell, seed: int, device) -> dict:
    from benchmark.harness import check, traffic
    from benchmark.reference import ops

    mix = cell.traffic
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}").Driver(
        cell, seed, device)
    driver.make_weights()
    pool = [(traffic.request(mix, cell.config, seed, i), 0.0, None)
            for i in range(2 * cell.check["sample"] + 4)]
    requests = [r for r, _, _ in check.pick_sample(pool, seed, cell.check["sample"])]
    t0 = time.perf_counter()
    fp8 = ops.Precision("fp8")
    control = [(r, 0.0, driver.reference(r, fp8)) for r in requests]
    return {"seed": seed, "requests": [[r.index, r.batch, r.mel_len] for r in requests],
            "control": check.compare(control, lambda r: driver.reference(r, ops.F32)),
            "seconds": time.perf_counter() - t0, "limits": cell.check["limits"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--rehearsal", action="store_true", help="tiny widths on the CPU")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    if args.rehearsal:
        from benchmark.harness.rehearsal import tiny

        cell.config, cell.traffic = tiny(cell.config, cell.traffic)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("calibrate needs a CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
