"""Latent Consistency Model sampling.

Reference `scheduling_lcm.py`: the S-step timestep grid, the consistency
boundary scalings and the sampling loop (start from N(0, I); at each step
predict eps, convert to x0-hat, blend with the boundary scalings, re-noise to
the next grid point except on the last step). Sampler state and schedule
math stay float32; the denoiser runs in `dtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from audiolcm_torch.diffusion.schedule import NoiseSchedule
from audiolcm_torch.nn.embeddings import guidance_scale_embedding


@dataclasses.dataclass(frozen=True)
class LCMConfig:
    num_inference_steps: int = 2
    original_inference_steps: int = 50
    guidance_scale: float = 5.0
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5


def lcm_inference_timesteps(num_inference_steps: int, original_inference_steps: int = 50,
                            num_train_timesteps: int = 1000,
                            strength: float = 1.0) -> np.ndarray:
    """The S descending timesteps; [999, 499] for S=2 with the defaults."""
    k = num_train_timesteps // original_inference_steps
    origin = np.arange(1, int(original_inference_steps * strength) + 1, dtype=np.int64) * k - 1
    origin = origin[::-1].copy()
    idx = np.floor(np.linspace(0, len(origin), num=num_inference_steps,
                               endpoint=False)).astype(np.int64)
    return origin[idx]


def boundary_scalings(timestep: torch.Tensor, timestep_scaling: float = 10.0,
                      sigma_data: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Consistency boundary coefficients (c_skip, c_out), float32."""
    ts = timestep.to(torch.float32) * timestep_scaling
    c_skip = sigma_data**2 / (ts**2 + sigma_data**2)
    c_out = ts / torch.sqrt(ts**2 + sigma_data**2)
    return c_skip, c_out


def lcm_step_coefs(schedule: NoiseSchedule, config: LCMConfig = LCMConfig(),
                   device=None) -> torch.Tensor:
    """(S, 6) float32 on `device`, per step the sampler's scalars:
    sqrt(a_t), sqrt(1 - a_t), the boundary scalings at t,
    and sqrt(a_prev), sqrt(1 - a_prev) of the re-noising. Computed on the
    CPU with the float32 ops the sampler would run on each scalar, and
    copied to the device once per (config, device) (`NoiseSchedule.
    on_device`): the loop copies nothing from the host, so it can be
    captured in a CUDA graph."""

    def make():
        steps = lcm_inference_timesteps(config.num_inference_steps,
                                        config.original_inference_steps, schedule.num_timesteps)
        alpha_prod = schedule.alphas_cumprod[steps]
        alpha_prev = np.append(alpha_prod[1:], alpha_prod[-1])
        a = torch.from_numpy(np.ascontiguousarray(alpha_prod, dtype=np.float32))
        a_prev = torch.from_numpy(np.ascontiguousarray(alpha_prev, dtype=np.float32))
        c_skip, c_out = boundary_scalings(torch.from_numpy(steps.astype(np.float32)),
                                          config.timestep_scaling, config.sigma_data)
        return torch.stack([torch.sqrt(a), torch.sqrt(1.0 - a), c_skip, c_out,
                            torch.sqrt(a_prev), torch.sqrt(1.0 - a_prev)], dim=1)

    return schedule.on_device(("lcm_step_coefs", config), device or "cpu", make)


def lcm_sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
               schedule: NoiseSchedule, shape: Sequence[int], config: LCMConfig = LCMConfig(),
               x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Run the S-step LCM loop; returns `denoised` (float32).

    denoise_fn(x_t, t, w_embedding) -> eps prediction, x shape (B, T, C).
    x_T (shape) and noise (S, *shape: the re-noising draw of each step; the
    last one is unused) are for parity tests; when absent they are drawn
    from `generator` on `device`."""
    batch = shape[0]
    steps = lcm_inference_timesteps(config.num_inference_steps,
                                    config.original_inference_steps, schedule.num_timesteps)
    coefs = lcm_step_coefs(schedule, config, device)

    w = torch.full((batch,), config.guidance_scale - 1.0, dtype=torch.float32, device=device)
    w_emb = guidance_scale_embedding(w, 256).to(dtype)
    if x_T is None:
        x_T = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    img = x_T.to(device=device, dtype=torch.float32)
    denoised = img
    for i, t in enumerate(steps):
        sqrt_a, sqrt_1m_a, c_skip, c_out, sqrt_a_prev, sqrt_1m_a_prev = coefs[i].unbind()
        ts = torch.full((batch,), int(t), dtype=torch.int32, device=device)
        eps = denoise_fn(img.to(dtype), ts, w_emb).to(torch.float32)
        x0 = (img - sqrt_1m_a * eps) / sqrt_a
        denoised = c_out * x0 + c_skip * img
        if i + 1 < len(steps):
            if noise is not None:
                z = noise[i].to(device=device, dtype=torch.float32)
            else:
                z = torch.randn(tuple(shape), generator=generator, device=device,
                                dtype=torch.float32)
            img = sqrt_a_prev * denoised + sqrt_1m_a_prev * z
    return denoised


class DDIMSolver:
    """Distillation-time DDIM step on the 50-step grid (`ddim_solver.py:11-35`,
    `audiolcm_tpu/diffusion/lcm.py:DDIMSolver`), its tables as buffers on
    `device`: `ddim_timesteps` (int64), `ddim_alpha_cumprods` and
    `ddim_alpha_cumprods_prev` (f32)."""

    def __init__(self, alphas_cumprod: np.ndarray, timesteps: int = 1000,
                 ddim_timesteps: int = 50, device=None):
        self.step_ratio = timesteps // ddim_timesteps
        ts = (np.arange(1, ddim_timesteps + 1) * self.step_ratio).round().astype(np.int64) - 1
        acp = np.asarray(alphas_cumprod)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.ddim_timesteps = torch.as_tensor(ts, device=device)
        self.ddim_alpha_cumprods = f32(acp[ts])
        self.ddim_alpha_cumprods_prev = f32(np.concatenate([acp[:1], acp[ts[:-1]]]))

    def ddim_step(self, pred_x0: torch.Tensor, pred_noise: torch.Tensor,
                  timestep_index: torch.Tensor) -> torch.Tensor:
        a_prev = self.ddim_alpha_cumprods_prev[timestep_index]
        a_prev = a_prev.reshape(a_prev.shape + (1,) * (pred_x0.dim() - a_prev.dim()))
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * pred_noise
