"""DDPM noise schedule, precomputed in float64 and stored as float32.

The "linear" beta schedule of the reference: betas = linspace(sqrt(b0),
sqrt(b1), N)^2 with b0=0.00085, b1=0.012 (configs/audiolcm.yaml), and the
tables `ddpm.py:116-168` derives from it (v_posterior mixes the posterior
variance towards beta). Arrays are numpy; the samplers read the few
entries they need, and the q/posterior helpers gather them per batch row
from f32 copies on the device, made once per device (`device_table`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def on_device(self, key, device, make) -> torch.Tensor:
        """make() (a host tensor) on `device`, copied once per (key, device)
        and built outside inference mode, so autograd may save it. What the
        samplers and helpers read through it copies nothing from the host
        after the first call, so it can be captured in a CUDA graph."""
        cache = self.__dict__.setdefault("_device_tables", {})
        full_key = (key, torch.device(device))
        if full_key not in cache:
            with torch.inference_mode(False):
                cache[full_key] = make().to(device)
        return cache[full_key]

    def device_table(self, name: str, device) -> torch.Tensor:
        """The table `name` as f32 on `device`."""
        return self.on_device(name, device,
                              lambda: torch.as_tensor(getattr(self, name), dtype=torch.float32))

    def _gather(self, name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """table[t] as f32 on like's device, shaped (B, 1, ..., 1) to
        broadcast against like."""
        vals = self.device_table(name, like.device)[t.long()]
        return vals.reshape(vals.shape + (1,) * (like.dim() - vals.dim()))

    @classmethod
    def linear(cls, timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012, v_posterior: float = 0.0) -> "NoiseSchedule":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, timesteps, dtype=np.float64) ** 2
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = (1 - v_posterior) * betas * (1.0 - acp_prev) / (1.0 - acp) + v_posterior * betas
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            betas=f32(betas), alphas_cumprod=f32(acp), alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward diffusion q(x_t | x_0) (`ddpm.py:273-277`)."""
        return (self._gather("sqrt_alphas_cumprod", t, x_start) * x_start
                + self._gather("sqrt_one_minus_alphas_cumprod", t, x_start) * noise)

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor,
                                 noise: torch.Tensor) -> torch.Tensor:
        """x0-hat from an eps prediction (`ddpm.py:215-219`)."""
        return (self._gather("sqrt_recip_alphas_cumprod", t, x_t) * x_t
                - self._gather("sqrt_recipm1_alphas_cumprod", t, x_t) * noise)

    def predict_eps_from_xstart(self, x_t: torch.Tensor, t: torch.Tensor,
                                x0: torch.Tensor) -> torch.Tensor:
        return ((self._gather("sqrt_recip_alphas_cumprod", t, x_t) * x_t - x0)
                / self._gather("sqrt_recipm1_alphas_cumprod", t, x_t))

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor):
        """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, log variance)
        (`ddpm.py:221-228`)."""
        mean = (self._gather("posterior_mean_coef1", t, x_t) * x_start
                + self._gather("posterior_mean_coef2", t, x_t) * x_t)
        return (mean, self._gather("posterior_variance", t, x_t),
                self._gather("posterior_log_variance_clipped", t, x_t))
