"""The CPU rehearsal: the same run at tiny widths, on the CPU, with the
program in float32, no CUDA graphs and no profiler. It checks the harness's
control flow and the comparison; its last line is `{"rehearsal": true,
...}` and never carries a metric."""

from __future__ import annotations

import copy
import io
import json
from contextlib import redirect_stdout

TINY = {
    "clap_text": dict(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
                      intermediate_size=32, max_position_embeddings=80, d_proj=32),
    "t5": dict(vocab_size=100, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=2),
    "dit": dict(context_dim=32, hidden_size=32, depth=1, num_heads=4),
    "vae": dict(ch=32, ch_mult=[1, 2], num_res_blocks=1),
    "vocoder": dict(upsample_initial_channel=192),
}
MEL_SCALE = 1 / 16  # 312 / 624 / 1248 -> 19 / 39 / 78, rounded down to even
TEACHER_STEPS = 4


def tiny(config: dict, traffic: dict) -> tuple:
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    for model, sizes in TINY.items():
        config[model].update(sizes)
    config["serving"]["compute_dtype"] = "float32"
    if config["sampler"]["kind"] == "ddim":
        config["sampler"]["num_steps"] = TEACHER_STEPS
    traffic["mel_lens"] = [max(8, int(m * MEL_SCALE) // 2 * 2) for m in traffic["mel_lens"]]
    return config, traffic


def rehearse(cell: str, seed: int, seconds: float = 0.5):
    """`run.py --rehearsal` in this process -> (exit code, its last line)."""
    from benchmark import run

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0", "--rehearsal"])
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None
