"""DDIM sampler for the teacher LDM (the 100-step eval path).

Reference `ldm/models/diffusion/ddim.py`, as `audiolcm_tpu/diffusion/ddim.py`
has it:
  * `make_ddim_timesteps('uniform')`: range(0, N, N//S) + 1, clipped at N-1;
  * eta-sigmas computed in float64 from the float32 alphas_cumprod, then
    stored as float32;
  * classifier-free guidance by batch doubling, cat([uncond, cond]) and
    e = e_u + s*(e_c - e_u);
  * x_prev = sqrt(a_prev) x0 + sqrt(1 - a_prev - sigma^2) e + sigma z T,
    with T the temperature.

The sampler state stays float32; the denoiser may run in another dtype.
torch cannot reproduce jax.random, so every draw can be passed in (x_T,
the per-step noise, the mask branch's q_sample noise); a draw not passed
in comes from `generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from audiolcm_torch import obs
from audiolcm_torch.diffusion.schedule import NoiseSchedule


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int = 1000) -> np.ndarray:
    c = num_ddpm_steps // num_ddim_steps
    return np.asarray(list(range(0, num_ddpm_steps, c))) + 1


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_steps: int = 100
    eta: float = 0.0
    guidance_scale: float = 1.0
    temperature: float = 1.0


def _tables(schedule: NoiseSchedule, num_steps: int, eta: float):
    """(timesteps, alphas, alphas_prev, sigmas) in ascending time order; the
    last three float64, from the float32 alphas_cumprod."""
    acp = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    ts = np.clip(make_ddim_timesteps(num_steps, schedule.num_timesteps), 0,
                 schedule.num_timesteps - 1)
    alphas = acp[ts]
    alphas_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return ts, alphas, alphas_prev, sigmas


@dataclasses.dataclass(frozen=True)
class StepCoefs:
    """One step's float32 scalars, computed in float32 as the JAX sampler's
    scan body computes them."""

    sqrt_a: float
    sqrt_one_minus_a: float
    sqrt_a_prev: float
    dir_coef: float  # sqrt(max(1 - a_prev - sigma^2, 0))
    sigma: float


def step_coefs(a, a_prev, sigma) -> StepCoefs:
    a, a_prev, sigma = np.float32(a), np.float32(a_prev), np.float32(sigma)
    one, zero = np.float32(1.0), np.float32(0.0)
    return StepCoefs(float(np.sqrt(a)), float(np.sqrt(one - a)), float(np.sqrt(a_prev)),
                     float(np.sqrt(np.maximum(one - a_prev - sigma * sigma, zero))), float(sigma))


def descending_steps(schedule: NoiseSchedule, config: DDIMConfig):
    """[(t, StepCoefs)] in sampling (descending time) order."""
    ts, alphas, alphas_prev, sigmas = _tables(schedule, config.num_steps, config.eta)
    return [(int(t), step_coefs(a, ap, s))
            for t, a, ap, s in zip(ts[::-1], alphas[::-1], alphas_prev[::-1], sigmas[::-1])]


def guided_eps_fn(denoise_fn: Callable, cond: torch.Tensor, uncond: Optional[torch.Tensor],
                  guidance_scale: float) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """(x, t) -> eps. With an uncond context and a scale other than 1, one
    batch-doubled forward over cat([uncond broadcast to cond, cond]) and
    e_u + s*(e_c - e_u); otherwise the conditional forward alone."""
    if uncond is None or guidance_scale == 1.0:
        return lambda x, t: denoise_fn(x, t, cond)
    c2 = torch.cat([uncond.expand(cond.shape), cond], dim=0)

    def eps(x, t):
        e_u, e_c = denoise_fn(torch.cat([x, x]), torch.cat([t, t]), c2).chunk(2, dim=0)
        return e_u + guidance_scale * (e_c - e_u)

    return eps


def x_prev_from(img: torch.Tensor, e: torch.Tensor, c: StepCoefs, temperature: float,
                z: Optional[torch.Tensor]) -> torch.Tensor:
    """One DDIM update; z is the step's draw (None when sigma is 0, where
    the noise term is exactly 0)."""
    pred_x0 = (img - c.sqrt_one_minus_a * e) / c.sqrt_a
    out = c.sqrt_a_prev * pred_x0 + c.dir_coef * e
    if z is not None and c.sigma != 0.0:
        out = out + c.sigma * z * temperature
    return out


def draw(given: Optional[torch.Tensor], shape: Sequence[int], generator, device) -> torch.Tensor:
    """The draw passed in (as f32 on device), or a fresh standard normal one."""
    if given is not None:
        return given.to(device=device, dtype=torch.float32)
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)


def ddim_sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
                schedule: NoiseSchedule, shape: Sequence[int], cond: torch.Tensor,
                uncond: Optional[torch.Tensor] = None, config: DDIMConfig = DDIMConfig(),
                x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                mask_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """denoise_fn(x, t, context) -> eps. Returns the final sample (f32).

    x_T (shape), noise (S, *shape: step i's draw, in sampling order) and
    mask_noise (S, *shape) replace the draws from `generator` on `device`
    (cond's device by default). mask/x0 inpaint: before each step the known
    region is re-imposed as q_sample(x0, t) * mask + (1 - mask) * x."""
    device = cond.device if device is None else torch.device(device)
    batch = shape[0]
    eps_fn = guided_eps_fn(denoise_fn, cond, uncond, config.guidance_scale)
    step = lambda drawn, i: None if drawn is None else drawn[i]
    img = draw(x_T, shape, generator, device)
    for i, (t, c) in enumerate(descending_steps(schedule, config)):
        with obs.span("ddim.step"):  # the host's issue of the step; no sync
            t_full = torch.full((batch,), t, dtype=torch.int32, device=device)
            if mask is not None:
                z = draw(step(mask_noise, i), shape, generator, device)
                img = schedule.q_sample(x0, t_full, z) * mask + (1.0 - mask) * img
            e_t = eps_fn(img, t_full)
            z = draw(step(noise, i), shape, generator, device) if c.sigma != 0.0 else None
            img = x_prev_from(img, e_t, c, config.temperature, z)
    return img
