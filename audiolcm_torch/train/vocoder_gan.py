"""BigVGAN vocoder GAN training: the generator against MPD + MRD
(`audiolcm_tpu/train/vocoder_gan.py`).

Reference `vocoder/bigvgan/train_vocoder.py:209-270` / `train.py`:
  * discriminator step: LSGAN sum_d [mean (1 - D(y))^2 + mean D(y^)^2] over
    MPD and MRD (`models.py:365-377`);
  * generator step: 45 * L1(mel(y), mel(y^)) + feature matching (2 * sum
    mean |f_r - f_g|, `models.py:356-362`) + adversarial sum mean
    (1 - D(y^))^2 (`models.py:380-390`);
  * AdamW(lr 1e-4, betas (0.8, 0.99)) for each side, the learning rate
    decayed by 0.999 per epoch, the epoch computed from each optimizer's
    update count (`steps_per_epoch` 1000), as the JAX trainer's schedule
    does. Weight decay is optax.adamw's default, 1e-4.
The mel loss uses the vocoder-training constants (fmax_for_loss; log10, as
the JAX package's MelSpectrogram). f32; BigVGAN is built unfused
(`pallas_stage_max_channels=0`): the fused stage has no backward. Under
torch.distributed the gradients are averaged over the ranks
(`parallel/mesh.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch
from torch import nn

from audiolcm_torch.parallel.mesh import average_gradients, mean_metrics_over_ranks
from audiolcm_torch.train.lcm_distill import OptimizerChain


@dataclasses.dataclass(frozen=True)
class VocoderGANConfig:
    learning_rate: float = 1.0e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999  # per epoch
    mel_weight: float = 45.0
    segment_size: int = 8192
    steps_per_epoch: int = 1000
    weight_decay: float = 1.0e-4  # optax.adamw's default


@dataclasses.dataclass
class VocoderGANState:
    step: int
    gen: nn.Module
    mpd: nn.Module
    mrd: nn.Module
    gen_opt: Any
    disc_opt: Any

    def state_dict(self) -> dict:
        return {"step": self.step, "gen": self.gen.state_dict(), "mpd": self.mpd.state_dict(),
                "mrd": self.mrd.state_dict(), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        for name in ("gen", "mpd", "mrd", "gen_opt", "disc_opt"):
            getattr(self, name).load_state_dict(sd[name])


def lr_schedule(cfg: VocoderGANConfig) -> Callable[[int], float]:
    """Update count n -> lr * decay ** (n // steps_per_epoch), in float32
    as optax evaluates it."""

    def fn(n) -> float:
        epoch = torch.tensor(float(n // cfg.steps_per_epoch), dtype=torch.float32)
        return float(cfg.learning_rate * torch.tensor(cfg.lr_decay, dtype=torch.float32) ** epoch)

    return fn


def make_optimizer(cfg: VocoderGANConfig, params) -> OptimizerChain:
    params = list(params)
    adamw = torch.optim.AdamW(params, lr=1.0, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8,
                              weight_decay=cfg.weight_decay)
    return OptimizerChain(params, adamw, lr_schedule(cfg))


def init_vocoder_gan_state(gen: nn.Module, mpd: nn.Module, mrd: nn.Module,
                           cfg: VocoderGANConfig, optimizer=None) -> VocoderGANState:
    """optimizer(params) -> an optimizer, `make_optimizer` by default; the
    discriminator's optimizer holds MPD's and MRD's parameters."""
    make = optimizer or (lambda p: make_optimizer(cfg, p))
    for m in (gen, mpd, mrd):
        m.train()
    return VocoderGANState(0, gen, mpd, mrd, make(list(gen.parameters())),
                           make(list(mpd.parameters()) + list(mrd.parameters())))


def lsgan_d_loss(reals: List[torch.Tensor], fakes: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2) for dr, dg in zip(reals, fakes))


def lsgan_g_loss(fakes: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.mean((1.0 - dg) ** 2) for dg in fakes)


def feature_matching_loss(fmap_r, fmap_g) -> torch.Tensor:
    return 2.0 * sum(torch.mean(torch.abs(rl - gl))
                     for dr, dg in zip(fmap_r, fmap_g) for rl, gl in zip(dr, dg))


def make_vocoder_gan_steps(cfg: VocoderGANConfig, mel_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Returns (disc_step, gen_step), each (state, mel, wav) -> (state,
    metrics) with mel (B, frames, mels) and wav (B, frames * hop); mel_fn
    is the loss's log-mel, wav (B, L) -> (B, mels, frames)."""

    def disc_step(state: VocoderGANState, mel: torch.Tensor, wav: torch.Tensor):
        with torch.no_grad():
            y_hat = state.gen(mel)
        params = [p for group in state.disc_opt.param_groups for p in group["params"]]
        r1, f1, _, _ = state.mpd(wav, y_hat)
        r2, f2, _, _ = state.mrd(wav, y_hat)
        loss = lsgan_d_loss(r1, f1) + lsgan_d_loss(r2, f2)
        state.disc_opt.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(params)
        state.disc_opt.step()
        return state, mean_metrics_over_ranks({"train/disc_loss": loss.detach()})

    def gen_step(state: VocoderGANState, mel: torch.Tensor, wav: torch.Tensor):
        params = list(state.gen.parameters())
        y_hat = state.gen(mel)
        with torch.no_grad():
            mel_real = mel_fn(wav)
        mel_loss = torch.mean(torch.abs(mel_real - mel_fn(y_hat))) * cfg.mel_weight
        _, f1, fr1, fg1 = state.mpd(wav, y_hat)
        _, f2, fr2, fg2 = state.mrd(wav, y_hat)
        fm = feature_matching_loss(fr1, fg1) + feature_matching_loss(fr2, fg2)
        adv = lsgan_g_loss(f1) + lsgan_g_loss(f2)
        loss = mel_loss + fm + adv
        state.gen_opt.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        average_gradients(params)
        state.gen_opt.step()
        state.step += 1
        return state, mean_metrics_over_ranks({
            "train/gen_loss": loss.detach(), "train/mel_loss": mel_loss.detach(),
            "train/fm_loss": fm.detach(), "train/adv_loss": adv.detach()})

    return disc_step, gen_step
