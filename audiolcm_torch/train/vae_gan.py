"""VAE GAN training: alternating generator and discriminator steps
(`audiolcm_tpu/train/vae_gan.py`).

Reference `ldm/models/autoencoder1d.py:79-150` and
`ldm/modules/losses_audio/contperceptual.py` with configs/autoencoder1d.yaml:
  * generator loss: L1 reconstruction summed per sample (logvar fixed at 0:
    the reference's loss.logvar is in neither optimizer) + kl_weight * KL +
    d_weight * disc_factor * (-mean D(rec)), disc_factor 2 from step
    disc_start (80001) on, else 0;
  * the adaptive d_weight = ||d nll / d w_last|| / (||d g / d w_last|| + 1e-4),
    clipped to [0, 1e4], times disc_weight 0.5 (contperceptual.py:61-72),
    w_last the decoder's conv_out weight: two `torch.autograd.grad` calls on
    the one forward graph (the ratio of norms does not depend on layout);
  * discriminator: LSGAN 0.5 (mean (1 - D(x))^2 + mean D(x^)^2) (or hinge,
    vanilla) + the R1 penalty 3 * mean (d sum D(x) / d x)^2 on real inputs,
    its gradient taken with create_graph=True and backpropagated through;
  * two Adam(lr, betas=(0.5, 0.9)), alternating.

BatchNorm as in the JAX step: the generator's adversarial term runs the
discriminator in eval mode; the discriminator step normalises both passes
with their batch statistics, and only the fake pass advances the running
statistics. The posterior sample's noise is drawn once per (generator,
discriminator) pair of steps, as the JAX trainer passes one key to both.
Under torch.distributed (`parallel/mesh.py`) the gradients and the
adaptive weight's two gradients are averaged over the ranks and the
discriminator's BatchNorm takes the global batch's statistics, so the
step equals one over the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.vae1d import DiagonalGaussian
from audiolcm_torch.parallel.mesh import (
    average_gradients,
    draw_shard,
    mean_metrics_over_ranks,
    mean_over_ranks,
)

Noise = Union[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class VAEGANConfig:
    disc_start: int = 80001
    kl_weight: float = 1.0e-6
    disc_weight: float = 0.5
    disc_factor: float = 2.0
    r1_weight: float = 3.0
    learning_rate: float = 4.5e-6  # base_lr; the caller applies accum * ngpu * bs
    adam_b1: float = 0.5
    adam_b2: float = 0.9
    disc_loss: str = "mse"  # 'mse' | 'hinge' | 'vanilla'


@dataclasses.dataclass
class VAEGANState:
    step: int
    vae: nn.Module
    disc: nn.Module
    ae_opt: Any
    disc_opt: Any

    def state_dict(self) -> dict:
        return {"step": self.step, "vae": self.vae.state_dict(), "disc": self.disc.state_dict(),
                "ae_opt": self.ae_opt.state_dict(), "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.vae.load_state_dict(sd["vae"])
        self.disc.load_state_dict(sd["disc"])
        self.ae_opt.load_state_dict(sd["ae_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])


def make_optimizer(cfg: VAEGANConfig, params) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2))


def init_vae_gan_state(vae: nn.Module, disc: nn.Module, cfg: VAEGANConfig,
                       optimizer: Optional[Callable] = None) -> VAEGANState:
    """optimizer(params) -> an optimizer, Adam(lr, (0.5, 0.9)) by default."""
    make = optimizer or (lambda p: make_optimizer(cfg, p))
    vae.train()
    disc.train()
    return VAEGANState(0, vae, disc, make(list(vae.parameters())),
                       make(list(disc.parameters())))


def adopt_weight(factor: float, step: int, threshold: int) -> float:
    return 0.0 if step < threshold else factor


def disc_loss_fn(kind: str, logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """vqperceptual.py hinge / vanilla and contperceptual.py:9-20 mse."""
    if kind == "mse":
        return 0.5 * (torch.mean((1.0 - logits_real) ** 2) + torch.mean(logits_fake ** 2))
    if kind == "hinge":
        return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))
    if kind == "vanilla":
        return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))
    raise ValueError(kind)


def to_disc_input(mel_btc: torch.Tensor) -> torch.Tensor:
    """(B, T, 80) -> the discriminator's (B, 1, 80, T) "image"."""
    return mel_btc.transpose(1, 2)[:, None]


def _recon(vae: nn.Module, mel: torch.Tensor, noise: Noise):
    """(reconstruction, nll, kl) per JAX's recon_losses: nll and kl summed
    and divided by the batch."""
    posterior = DiagonalGaussian(vae.encode_moments(mel))
    eps = noise(posterior.mean) if callable(noise) else noise
    recon = vae.decode(posterior.sample(noise=eps))
    nll = torch.sum(torch.abs(mel - recon)) / mel.shape[0]
    kl = torch.sum(posterior.kl()) / mel.shape[0]
    return recon, nll, kl


def make_vae_gan_steps(cfg: VAEGANConfig, last_layer: str = "decoder.conv_out.weight"):
    """Returns (gen_step, disc_step, step). gen_step(state, mel, noise) and
    disc_step(state, mel, noise) take mel (B, T, 80) and the posterior's
    noise (a tensor like its mean, or a function of the mean that returns
    it); step(state, mel, generator=None, noise=None) runs both with one
    noise draw (from `generator` unless given). Each returns (state,
    metrics), updating the state's modules and optimizers in place;
    metrics are 0-dim tensors on the device."""

    def gen_step(state: VAEGANState, mel: torch.Tensor, noise: Noise):
        params = list(state.vae.parameters())
        last = state.vae.get_parameter(last_layer)
        recon, nll, kl = _recon(state.vae, mel, noise)
        g_loss = -torch.mean(state.disc(to_disc_input(recon), train=False))
        nll_g = mean_over_ranks(torch.autograd.grad(nll, last, retain_graph=True)[0])
        g_g = mean_over_ranks(torch.autograd.grad(g_loss, last, retain_graph=True)[0])
        d_weight = torch.clamp(torch.linalg.vector_norm(nll_g)
                               / (torch.linalg.vector_norm(g_g) + 1e-4), 0.0, 1e4)
        d_weight = (d_weight * cfg.disc_weight).detach()
        factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
        loss = nll + cfg.kl_weight * kl + d_weight * factor * g_loss
        state.ae_opt.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        average_gradients(params)
        state.ae_opt.step()
        return state, mean_metrics_over_ranks({
            "train/nll_loss": nll.detach(), "train/kl_loss": kl.detach(),
            "train/g_loss": g_loss.detach(), "train/d_weight": d_weight,
            "train/total_loss": loss.detach()})

    def disc_step(state: VAEGANState, mel: torch.Tensor, noise: Noise):
        disc = state.disc
        params = list(disc.parameters())
        with torch.no_grad():
            recon, _, _ = _recon(state.vae, mel, noise)
        real = to_disc_input(mel).detach().requires_grad_(True)
        # the real pass normalises with its batch statistics and discards them
        logits_real = disc(real, train=True, update_stats=False)
        r1_grads, = torch.autograd.grad(logits_real.sum(), real, create_graph=True)
        logits_fake = disc(to_disc_input(recon), train=True, update_stats=True)
        factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
        r1 = torch.mean(r1_grads ** 2)
        d_loss = factor * disc_loss_fn(cfg.disc_loss, logits_real, logits_fake) + cfg.r1_weight * r1
        state.disc_opt.zero_grad(set_to_none=True)
        d_loss.backward(inputs=params)
        average_gradients(params)
        state.disc_opt.step()
        state.step += 1
        return state, mean_metrics_over_ranks({
            "train/disc_loss": d_loss.detach(), "train/logits_real": logits_real.detach().mean(),
            "train/logits_fake": logits_fake.detach().mean(), "train/r1_penalty": r1.detach()})

    def step(state: VAEGANState, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None):
        drawn = {}

        def noise_for(mean: torch.Tensor) -> torch.Tensor:
            if "eps" not in drawn:
                drawn["eps"] = noise if noise is not None else draw_shard(
                    lambda n: torch.randn((n,) + mean.shape[1:], generator=generator,
                                          device=mean.device, dtype=mean.dtype), mean.shape[0])
            return drawn["eps"]

        state, gm = gen_step(state, mel, noise_for)
        state, dm = disc_step(state, mel, noise_for)
        return state, {**gm, **dm}

    return gen_step, disc_step, step
