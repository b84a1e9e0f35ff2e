"""PLMS (pseudo linear multistep) sampler for the teacher LDM.

Reference `ldm/models/diffusion/plms.py:115-236`, as
`audiolcm_tpu/diffusion/plms.py` has it: Adams-Bashforth multistep on the
eps predictions with the order ramping 1 -> 4:
  step 0: pseudo improved Euler (2 model evals, e' = (e_t + e_next) / 2)
  step 1: e' = (3 e - e_{-1}) / 2
  step 2: e' = (23 e - 16 e_{-1} + 5 e_{-2}) / 12
  step >=3: e' = (55 e - 59 e_{-1} + 37 e_{-2} - 9 e_{-3}) / 24
with the DDIM coefficient tables and batch-doubled CFG of `ddim.py`; the
next timestep of the last step is clamped to itself. The sampler state
stays float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from audiolcm_torch.diffusion.ddim import (
    DDIMConfig,
    descending_steps,
    draw,
    guided_eps_fn,
    x_prev_from,
)
from audiolcm_torch.diffusion.schedule import NoiseSchedule


def plms_sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
                schedule: NoiseSchedule, shape: Sequence[int], cond: torch.Tensor,
                uncond: Optional[torch.Tensor] = None, config: DDIMConfig = DDIMConfig(),
                x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """denoise_fn(x, t, context) -> eps. Returns the final sample (f32).

    noise is (S, 2, *shape): [i, 0] is step i's draw for the Euler half step
    (read at step 0 only), [i, 1] the draw of its update. Draws not passed
    in come from `generator` on `device` (cond's device by default)."""
    device = cond.device if device is None else torch.device(device)
    batch = shape[0]
    eps_fn = guided_eps_fn(denoise_fn, cond, uncond, config.guidance_scale)
    steps = descending_steps(schedule, config)
    t_next = [t for t, _ in steps[1:]] + [steps[-1][0]]
    full = lambda t: torch.full((batch,), t, dtype=torch.int32, device=device)
    # draw j of step i; none is needed where sigma is 0 (the noise term is 0)
    z = lambda i, j, c: (None if c.sigma == 0.0 else
                         draw(None if noise is None else noise[i, j], shape, generator, device))
    img = draw(x_T, shape, generator, device)
    hist = []  # [e_{-1}, e_{-2}, e_{-3}]
    for i, (t, c) in enumerate(steps):
        e_t = eps_fn(img, full(t))
        if i == 0:
            x_half = x_prev_from(img, e_t, c, config.temperature, z(i, 0, c))
            e_prime = (e_t + eps_fn(x_half, full(t_next[i]))) / 2.0
        elif i == 1:
            e_prime = (3 * e_t - hist[0]) / 2.0
        elif i == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12.0
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24.0
        img = x_prev_from(img, e_prime, c, config.temperature, z(i, 1, c))
        hist = [e_t] + hist[:2]
    return img
