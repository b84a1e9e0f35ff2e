"""Host-clock ms, device busy ms and idle share of the eager batch-8 10 s
LCM serving generate (bf16, full width, random weights from a seed), for
holding two checkouts of the repository against each other on one card.

    PYTHONPATH=<checkout> python audiolcm_torch/tools/generate_idle.py [--iters 5]

`audiolcm_torch` and the checkout's `chip_smoke` (its modules, token ids
and profiler) are imported from the checkout named by PYTHONPATH, so one
copy of this script measures any checkout whose chip_smoke.py has
`build_modules`, `token_ids` and `profile_run`. Prints one JSON line: the
ms of each generate, their median, and torch.profiler's busy ms and idle
share over one more generate, with nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    import audiolcm_torch
    import chip_smoke as cs
    from audiolcm_torch.pipeline import AudioLCMPipeline

    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = cs.build_modules(device, full=True)
    pipe = AudioLCMPipeline(mods, compute_dtype=torch.bfloat16, device=device)
    ids = cs.token_ids(mods, 8, 77, seed=0)
    gen = torch.Generator(device).manual_seed(2)
    run = lambda: pipe.generate(ids[0], ids[1], 312, generator=gen)
    run()  # warm-up: kernels built, algorithms chosen
    torch.cuda.synchronize()
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    median = sorted(times)[len(times) // 2]
    prof = cs.profile_run(run, median, top=3, watch=("amp_stage",))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"package": audiolcm_torch.__file__, "ms": times, "median_ms": median,
                      "device_busy_ms": prof["device_busy_ms"],
                      "idle_share": prof["idle_share"], "watched": prof["watched"],
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
