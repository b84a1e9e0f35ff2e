"""Learning-rate schedules, `ldm/lr_scheduler.py` (`audiolcm_tpu/train/
lr_schedules.py`).

- `warmup_cosine`  — LambdaWarmUpCosineScheduler (`ldm/lr_scheduler.py:4-33`):
  linear warm-up, then one cosine decay to lr_min.
- `warmup_cosine2` — LambdaWarmUpCosineScheduler2 (`:36-79`): per-cycle
  warm-up then cosine.
- `lambda_linear`  — LambdaLinearScheduler (`:81-97`): per-cycle warm-up
  then linear decay f_max -> f_min.

Each returns a step -> learning rate function for
`torch.optim.lr_scheduler.LambdaLR` over an optimizer built with lr=1.0:
LambdaLR's step n is optax's update count n, and the value is the float32
number optax computes at that count (the same float32 ops on the same
constants, evaluated here with CPU tensors). `build_schedule` resolves a
YAML `scheduler_config` block as the reference's
`instantiate_from_config(scheduler_config)` does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

Schedule = Callable[[int], float]
F32 = torch.float32


def _n(step) -> torch.Tensor:
    return torch.tensor(float(step), dtype=F32)


def warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                  lr_start: float, max_decay_steps: int) -> Schedule:
    """LambdaWarmUpCosineScheduler (`ldm/lr_scheduler.py:17-30`)."""

    def fn(step) -> float:
        n = _n(step)
        warm = (lr_max - lr_start) / warm_up_steps * n + lr_start
        t = torch.clamp((n - warm_up_steps) / (max_decay_steps - warm_up_steps), max=1.0)
        decay = lr_min + 0.5 * (lr_max - lr_min) * (1 + torch.cos(t * math.pi))
        return float(torch.where(n < warm_up_steps, warm, decay))

    return fn


def _cycles(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    if not (len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start)
            == len(cycle_lengths)):
        raise ValueError("per-cycle lists must be of equal length")
    t = lambda v: torch.tensor([float(x) for x in v], dtype=F32)
    cum = [0]
    for c in cycle_lengths:
        cum.append(cum[-1] + int(c))
    return (t(warm_up_steps), t(f_min), t(f_max), t(f_start), t(cycle_lengths), t(cum))


def _cycle_schedule(warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                    decay_fn) -> Schedule:
    """The cycle lookup both cycle schedulers share: the first cycle c with
    n <= cum[c+1] (clamped to the last cycle, where the final value holds),
    n within it, linear warm-up, then decay_fn(n, c, tables)."""
    wu, fmn, fmx, fst, cl, cum = _cycles(warm_up_steps, f_min, f_max, f_start, cycle_lengths)
    last = len(cycle_lengths) - 1

    def fn(step) -> float:
        n0 = _n(step)
        c = int(torch.clamp(torch.searchsorted(cum[1:], n0, right=False), 0, last))
        n = torch.minimum(n0 - cum[c], cl[c])
        warm = (fmx[c] - fst[c]) / wu[c] * n + fst[c]
        decay = decay_fn(n, c, wu, fmn, fmx, cl)
        return float(torch.where(n < wu[c], warm, decay))

    return fn


def warmup_cosine2(warm_up_steps: Sequence[int], f_min: Sequence[float],
                   f_max: Sequence[float], f_start: Sequence[float],
                   cycle_lengths: Sequence[int]) -> Schedule:
    """LambdaWarmUpCosineScheduler2 (`ldm/lr_scheduler.py:59-76`); past the
    last cycle the final value holds."""

    def decay(n, c, wu, fmn, fmx, cl):
        t = torch.clamp((n - wu[c]) / (cl[c] - wu[c]), max=1.0)
        return fmn[c] + 0.5 * (fmx[c] - fmn[c]) * (1 + torch.cos(t * math.pi))

    return _cycle_schedule(warm_up_steps, f_min, f_max, f_start, cycle_lengths, decay)


def lambda_linear(warm_up_steps: Sequence[int], f_min: Sequence[float],
                  f_max: Sequence[float], f_start: Sequence[float],
                  cycle_lengths: Sequence[int]) -> Schedule:
    """LambdaLinearScheduler (`ldm/lr_scheduler.py:83-97`): after warm-up
    f = f_min + (f_max - f_min) * (cycle_len - n) / cycle_len; the shipped
    configs use f_max = f_min = 1, a constant."""

    def decay(n, c, wu, fmn, fmx, cl):
        return fmn[c] + (fmx[c] - fmn[c]) * (cl[c] - n) / cl[c]

    return _cycle_schedule(warm_up_steps, f_min, f_max, f_start, cycle_lengths, decay)


_REGISTRY = {
    "LambdaWarmUpCosineScheduler": warmup_cosine,
    "LambdaWarmUpCosineScheduler2": warmup_cosine2,
    "LambdaLinearScheduler": lambda_linear,
}
_VERY_LARGE = 10_000_000_000_000  # configs/audiolcm.yaml cycle_lengths


def build_schedule(scheduler_config: Optional[dict], base_lr: float,
                   default_warmup: int = 10000) -> Schedule:
    """YAML scheduler_config block -> step -> base_lr * f(step). None gives
    the shipped LambdaLinear defaults (warm_up_steps=[default_warmup],
    f_start=1e-6, f_max=f_min=1: `configs/audiolcm.yaml:26-35`)."""
    if not scheduler_config:
        mult = lambda_linear([default_warmup], [1.0], [1.0], [1.0e-6], [_VERY_LARGE])
    else:
        target = str(scheduler_config.get("target", "")).rsplit(".", 1)[-1]
        if target not in _REGISTRY:
            raise ValueError(f"unknown lr scheduler target {scheduler_config.get('target')!r};"
                             f" known: {sorted(_REGISTRY)}")
        params = dict(scheduler_config.get("params", {}))
        params.pop("verbosity_interval", None)  # print cadence, not math
        mult = _REGISTRY[target](**params)
    return lambda step: float(base_lr * torch.tensor(mult(step), dtype=F32))
