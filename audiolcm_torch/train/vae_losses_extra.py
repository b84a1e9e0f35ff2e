"""The VAE GAN's loss variants beyond the shipped contperceptual loss
(`audiolcm_tpu/train/vae_losses_extra.py`).

Reference first-stage losses, selected by `lossconfig.target`:
  * multiw — `contperceptual_multiw.py`: the multi-window discriminator
    alone ("bn", reduction "stack");
  * dis    — `contperceptual_dis.py`: the PatchGAN and the multi-window
    discriminator ("in", "stack"), an adaptive weight per tower and the
    two discriminator losses summed (`:60-137`);
  * mask   — `contperceptual_mask.py`: the PatchGAN on reconstructions put
    back to pad_value outside the frames whose mel mean exceeds pad_value;
  * vq     — `vqperceptual.py:19-135`: the PatchGAN with nll the mean L1
    (not the per-sample sum) and no KL; the codebook term is added when a
    codebook loss is passed.
Each tower's adaptive weight is ||d nll / d w_last|| / (||d g / d w_last||
+ 1e-4) at the decoder's conv_out weight, clipped to [0, 1e4], times
disc_weight and detached (two `torch.autograd.grad` calls on the one
forward graph), gated by `adopt_weight` from disc_start on.

As the JAX steps and their one caller (`cli/train.py`): the towers run in
eval mode (their initial BatchNorm statistics, no dropout) inside both
losses; one draw of the posterior noise and of the window starts serves
the generator and the discriminator step of a training step, and the real
and fake passes of the discriminator step (`Draws`); `disc_step` advances
`step`, `gen_step` does not; the metric keys are JAX's. perceptual_fn
(mels (B, T, F) -> (B,) or (B, 1, 1, 1), e.g. `models/lpaps.lpaps_perceptual`)
adds perceptual_weight x its per-sample distance to every bin's L1 term.
Under torch.distributed the gradients and the adaptive weights' gradients
are averaged over the ranks, and every rank draws the same window starts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from audiolcm_torch.models.multi_window_disc import draw_starts
from audiolcm_torch.models.vae1d import DiagonalGaussian
from audiolcm_torch.parallel.mesh import (
    average_gradients,
    draw_shard,
    mean_metrics_over_ranks,
    mean_over_ranks,
)
from audiolcm_torch.train.vae_gan import Noise, adopt_weight, disc_loss_fn, to_disc_input

VARIANTS = ("multiw", "dis", "mask", "vq")


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    variant: str = "multiw"  # 'multiw' | 'dis' | 'mask' | 'vq'
    disc_start: int = 80001
    kl_weight: float = 1.0
    codebook_weight: float = 1.0  # vq only
    disc_weight: float = 1.0
    disc_factor: float = 1.0
    perceptual_weight: float = 0.0
    disc_loss: str = "hinge"
    pad_value: float = -1.0  # mask variant (contperceptual_mask.py:19)
    learning_rate: float = 4.5e-6
    adam_b1: float = 0.5
    adam_b2: float = 0.9

    @property
    def use_patch(self) -> bool:
        return self.variant in ("dis", "mask", "vq")

    @property
    def use_multi(self) -> bool:
        return self.variant in ("multiw", "dis")


@dataclasses.dataclass
class VariantState:
    step: int
    vae: nn.Module
    discs: nn.ModuleDict  # 'patch' and/or 'multi', whichever the variant uses
    ae_opt: Any
    disc_opt: Any

    def state_dict(self) -> dict:
        return {"step": self.step, "vae": self.vae.state_dict(), "discs": self.discs.state_dict(),
                "ae_opt": self.ae_opt.state_dict(), "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.vae.load_state_dict(sd["vae"])
        self.discs.load_state_dict(sd["discs"])
        self.ae_opt.load_state_dict(sd["ae_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])


class Draws(NamedTuple):
    """One training step's random numbers: the posterior's noise (a tensor
    like its mean, or a function of the mean that returns it, as
    `vae_gan.Noise`) and the multi-window tower's raw window starts (None
    without that tower)."""

    noise: Noise
    starts: Optional[torch.Tensor] = None


def sequence_mask(length: torch.Tensor, max_length: int) -> torch.Tensor:
    """contperceptual_mask.py:9-13: (B,) -> (B, max_length) bool."""
    return torch.arange(max_length, device=length.device)[None, :] < length[:, None]


def mel_lengths_from_pad(mel_btc: torch.Tensor, pad_value: float) -> torch.Tensor:
    """Valid frames per sample: those whose mean over the mel bins exceeds
    pad_value (contperceptual_mask.py:67-69)."""
    return (mel_btc.mean(dim=-1) > pad_value).sum(dim=-1)


def _adaptive_weight(nll: torch.Tensor, g_loss: torch.Tensor, last: torch.Tensor,
                     disc_weight: float) -> torch.Tensor:
    nll_g = mean_over_ranks(torch.autograd.grad(nll, last, retain_graph=True)[0])
    g_g = mean_over_ranks(torch.autograd.grad(g_loss, last, retain_graph=True)[0])
    w = torch.linalg.vector_norm(nll_g) / (torch.linalg.vector_norm(g_g) + 1e-4)
    return (torch.clamp(w, 0.0, 1e4) * disc_weight).detach()


def init_variant_state(vae: nn.Module, discs: dict, cfg: VariantConfig,
                       optimizer: Optional[Callable] = None) -> VariantState:
    """discs: {'patch': NLayerDiscriminator2D, 'multi':
    MultiWindowDiscriminatorWrapper}, those the variant uses.
    optimizer(params) -> an optimizer, Adam(lr, (0.5, 0.9)) by default."""
    make = optimizer or (lambda p: torch.optim.Adam(p, lr=cfg.learning_rate,
                                                    betas=(cfg.adam_b1, cfg.adam_b2)))
    discs = nn.ModuleDict(discs)
    vae.train()
    discs.eval()
    return VariantState(0, vae, discs, make(list(vae.parameters())),
                        make(list(discs.parameters())))


def make_variant_gan_steps(cfg: VariantConfig, perceptual_fn: Optional[Callable] = None,
                           last_layer: str = "decoder.conv_out.weight"):
    """Returns (gen_step, disc_step, step). gen_step(state, mel, draws,
    codebook_loss=None) and disc_step(state, mel, draws) take mel (B, T, F)
    and the step's `Draws`; step(state, mel, generator=None, noise=None,
    starts=None) runs both with one draw of each (from `generator` unless
    given). Each returns (state, metrics), the modules and optimizers
    updated in place; metrics are 0-dim tensors on the device."""
    if cfg.variant not in VARIANTS:
        raise ValueError(f"variant {cfg.variant!r}: expected one of {VARIANTS}")

    def rec_terms(vae, mel, noise):
        posterior = DiagonalGaussian(vae.encode_moments(mel))
        eps = noise(posterior.mean) if callable(noise) else noise
        recon = vae.decode(posterior.sample(noise=eps))
        rec = torch.abs(mel - recon)
        if cfg.perceptual_weight > 0 and perceptual_fn is not None:
            rec = rec + cfg.perceptual_weight * perceptual_fn(mel, recon).reshape(-1, 1, 1)
        if cfg.variant == "vq":
            return recon, torch.mean(rec), mel.new_zeros(())  # vqperceptual.py:80
        return recon, torch.sum(rec) / mel.shape[0], torch.sum(posterior.kl()) / mel.shape[0]

    def mask_recon(mel, recon):
        """contperceptual_mask.py:89-90: padded frames back to pad_value."""
        m = sequence_mask(mel_lengths_from_pad(mel, cfg.pad_value), mel.shape[1])
        m = m[..., None].to(mel.dtype)
        return recon * m + (1.0 - m) * cfg.pad_value

    def logits(state, key, x, starts):
        tower = state.discs[key]
        if key == "patch":
            return tower(to_disc_input(x), train=False)
        return tower(x, starts=starts, train=False)["y"]

    def gen_step(state: VariantState, mel: torch.Tensor, draws: Draws,
                 codebook_loss: Optional[torch.Tensor] = None):
        params = list(state.vae.parameters())
        last = state.vae.get_parameter(last_layer)
        recon, nll, kl = rec_terms(state.vae, mel, draws.noise)
        if cfg.variant == "mask":
            recon = mask_recon(mel, recon)
        g = {}
        if cfg.use_patch:
            g["g"] = -torch.mean(logits(state, "patch", recon, None))
        if cfg.use_multi:
            g["g_multi"] = -torch.mean(logits(state, "multi", recon, draws.starts))
        factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
        loss = nll + cfg.kl_weight * kl
        metrics = {"train/nll_loss": nll.detach(), "train/kl_loss": kl.detach()}
        if cfg.variant == "vq" and codebook_loss is not None:
            loss = loss + cfg.codebook_weight * torch.mean(codebook_loss)
            metrics["train/quant_loss"] = torch.mean(codebook_loss).detach()
        for key, g_loss in g.items():
            w = _adaptive_weight(nll, g_loss, last, cfg.disc_weight)
            loss = loss + w * factor * g_loss
            metrics[f"train/{key}_loss"] = g_loss.detach()
            metrics[f"train/d_weight_{key}"] = w
        metrics["train/total_loss"] = loss.detach()
        state.ae_opt.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        average_gradients(params)
        state.ae_opt.step()
        return state, mean_metrics_over_ranks(metrics)

    def disc_step(state: VariantState, mel: torch.Tensor, draws: Draws):
        params = list(state.discs.parameters())
        with torch.no_grad():
            recon, _, _ = rec_terms(state.vae, mel, draws.noise)
            if cfg.variant == "mask":
                recon = mask_recon(mel, recon)
        factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)
        d_loss = mel.new_zeros(())
        metrics = {}
        for key in ("patch", "multi"):
            if key not in state.discs:
                continue
            lr_ = logits(state, key, mel, draws.starts)  # one set of windows for both
            lf = logits(state, key, recon, draws.starts)
            d = factor * disc_loss_fn(cfg.disc_loss, lr_, lf)
            d_loss = d_loss + d
            metrics["train/disc_loss" if key == "patch" else "train/disc_loss_multi"] = d.detach()
            if key == "patch" or not cfg.use_patch:
                metrics.update({"train/logits_real": lr_.detach().mean(),
                                "train/logits_fake": lf.detach().mean()})
        metrics["train/disc_loss_total"] = d_loss.detach()
        state.disc_opt.zero_grad(set_to_none=True)
        d_loss.backward(inputs=params)
        average_gradients(params)
        state.disc_opt.step()
        state.step += 1
        return state, mean_metrics_over_ranks(metrics)

    def step(state: VariantState, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None, starts: Optional[torch.Tensor] = None):
        drawn = {}

        def noise_for(mean: torch.Tensor) -> torch.Tensor:
            if "eps" not in drawn:
                drawn["eps"] = noise if noise is not None else draw_shard(
                    lambda n: torch.randn((n,) + mean.shape[1:], generator=generator,
                                          device=mean.device, dtype=mean.dtype), mean.shape[0])
            return drawn["eps"]

        if starts is None and "multi" in state.discs:
            starts = draw_starts(len(state.discs["multi"].time_lengths), mel.shape[1], generator,
                                 mel.device)
        draws = Draws(noise_for, starts)
        state, gm = gen_step(state, mel, draws)
        state, dm = disc_step(state, mel, draws)
        return state, {**gm, **dm}

    return gen_step, disc_step, step
