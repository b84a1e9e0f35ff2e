"""The two samplers and the whole generate, plainly, in float32.

- The DDPM schedule: betas = linspace(sqrt(0.00085), sqrt(0.012), 1000)^2
  in float64, alphas_cumprod stored as float32 (configs/audiolcm.yaml).
- LCM (scheduling_lcm.py): timesteps [999, 499] for 2 steps on the 50-step
  grid; at each step eps -> x0 -> c_out x0 + c_skip x with the consistency
  boundary scalings (sigma_data 0.5, timestep scaling 10); re-noise to the
  next grid point with a fresh draw, except after the last step. The
  denoiser sees the w-embedding of guidance - 1.
- DDIM (ldm/models/diffusion/ddim.py), eta 0: the uniform grid
  range(0, 1000, 1000 // S) + 1, classifier-free guidance
  e_u + s (e_c - e_u), x_prev = sqrt(a_prev) x0 + sqrt(1 - a_prev) e.

Draws: x_T first, then (LCM) one normal draw per step but the last, all
float32 of the latent's shape, from the generator the request hands in.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model, ops


def alphas_cumprod(sched: dict) -> np.ndarray:
    betas = np.linspace(sched["linear_start"] ** 0.5, sched["linear_end"] ** 0.5,
                        sched["timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def lcm_timesteps(steps: int, original: int, n_train: int) -> np.ndarray:
    k = n_train // original
    origin = (np.arange(1, original + 1) * k - 1)[::-1]
    return origin[np.floor(np.linspace(0, original, num=steps, endpoint=False)).astype(np.int64)]


def draws(generator, shape, n_noise: int, device):
    """x_T and the per-step re-noising draws, in the samplers' order."""
    x_t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return x_t, [torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
                 for _ in range(n_noise)]


def lcm_sample(sd, dit_cfg, sampler, sched, ctx, x_t, noise, p=ops.F32):
    acp = alphas_cumprod(sched)
    ts = lcm_timesteps(sampler["num_inference_steps"], sampler["original_inference_steps"],
                       sched["timesteps"])
    f32 = np.float32
    b, dev = x_t.shape[0], x_t.device
    w_emb = model.guidance_embedding(torch.full((b,), sampler["guidance_scale"] - 1.0, device=dev))
    x = x_t
    for i, t in enumerate(ts):
        a = f32(acp[t])
        a_prev = f32(acp[ts[i + 1]]) if i + 1 < len(ts) else a
        s = f32(t) * f32(10.0)
        c_skip = f32(0.25) / (s * s + f32(0.25))
        c_out = s / np.sqrt(s * s + f32(0.25))
        eps = model.dit(sd, dit_cfg, x, torch.full((b,), int(t), device=dev), ctx, w_emb, p)
        x0 = (x - float(np.sqrt(f32(1) - a)) * eps) / float(np.sqrt(a))
        denoised = float(c_out) * x0 + float(c_skip) * x
        if i + 1 < len(ts):
            x = float(np.sqrt(a_prev)) * denoised + float(np.sqrt(f32(1) - a_prev)) * noise[i]
    return denoised


def ddim_sample(sd, dit_cfg, sampler, sched, ctx, uncond, x_t, p=ops.F32):
    acp = alphas_cumprod(sched).astype(np.float64)
    n = sched["timesteps"]
    ts = np.clip(np.arange(0, n, n // sampler["num_steps"]) + 1, 0, n - 1)
    prev = np.concatenate([acp[:1], acp[ts[:-1]]])
    s, b, f32 = sampler["guidance_scale"], x_t.shape[0], np.float32
    uc = uncond.expand(ctx.shape)
    x = x_t
    for t, a, a_prev in zip(ts[::-1], acp[ts][::-1], prev[::-1]):
        a, a_prev = f32(a), f32(a_prev)
        tt = torch.full((b,), int(t), device=x.device)
        e_u = model.dit(sd, dit_cfg, x, tt, uc, None, p)
        e_c = model.dit(sd, dit_cfg, x, tt, ctx, None, p)
        e = e_u + s * (e_c - e_u)
        x0 = (x - float(np.sqrt(f32(1) - a)) * e) / float(np.sqrt(a))
        x = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(f32(1) - a_prev)) * e
    return x


def generate(sds: dict, config: dict, clap_ids, t5_ids, x_t, noise, uncond_ids=None,
             p: ops.Precision = ops.F32):
    """Token ids and draws -> (wav (B, 256 * 2T), mel (B, 2T, 80)), float32."""
    sampler, sched = config["sampler"], config["schedule"]
    if sampler["kind"] not in ("lcm", "ddim"):
        raise ValueError(f"unknown sampler {sampler['kind']!r}")
    with ops.computed_in(p):
        ctx = model.context(sds, config, clap_ids, t5_ids, p)
        if sampler["kind"] == "lcm":
            z = lcm_sample(sds["dit"], config["dit"], sampler, sched, ctx, x_t, noise, p)
        else:
            uc = model.context(sds, config, *uncond_ids, p)
            z = ddim_sample(sds["dit"], config["dit"], sampler, sched, ctx, uc, x_t, p)
        mel = model.vae_decode(sds["vae"], config["vae"], z / config["scale_factor"], p)
        return model.vocoder(sds["vocoder"], config["vocoder"], mel, p), mel
