"""Training steps of the reference's auxiliary latent-diffusion variants
(`audiolcm_tpu/train/ldm_variants.py`).

  * Inpainting LDM (`ldm/models/diffusion/ddpm_audio_inpaint.py`): the
    denoiser's input is cat([x_noisy, masked latent, resized mask]) on the
    channel axis and the text embedding rides as context; the teacher's
    eps-MSE.
  * Temporal-order LDM (`ddpm_audio_order.py`): the same objective with
    the order-token conditioning of a ConcatOrderDiT.
  * Noisy-latent classifier (`classifier.py`): q_sample at a random t,
    logits on x_noisy, cross-entropy and top-k accuracy, AdamW with weight
    decay 1e-2 (no clipping, constant rate), and the validation accuracy
    at each noise level.

Latents are channels-first (B, C, T'); the caller's `apply` function maps
them onto its model. The inpaint and order steps share the teacher's
state and optimiser (global-norm clip, AdamW, warm-up). t and the noise
come from an explicit torch.Generator unless injected; under
torch.distributed each rank keeps its rows of the global batch's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.diffusion.schedule import NoiseSchedule
from audiolcm_torch.parallel.mesh import draw_shard, mean_over_ranks
from audiolcm_torch.train.lcm_distill import adamw_chain, full_grads, injected_or
from audiolcm_torch.train.teacher import TeacherConfig, TeacherState


def resize_mask_nearest(mask: torch.Tensor, target_len: int) -> torch.Tensor:
    """A (B, 1, T) or (B, T) mask at the latent length, (B, 1, target_len):
    row (i * T) // target_len, an integer map (F.interpolate's float scale
    can pick other rows)."""
    if mask.dim() == 2:
        mask = mask[:, None, :]
    src = mask.shape[-1]
    idx = torch.arange(target_len, device=mask.device) * src // target_len
    return mask.index_select(-1, idx)


def build_inpaint_cond(masked_latent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """c_concat = cat([masked latent (B, C, T'), the mask at T']) on the
    channel axis (`ddpm_audio_inpaint.py:295-298`)."""
    resized = resize_mask_nearest(mask, masked_latent.shape[-1])
    return torch.cat([masked_latent, resized.to(masked_latent.dtype)], dim=1)


def _draws(schedule: NoiseSchedule, z: torch.Tensor, generator, t, noise):
    bsz, dev = z.shape[0], z.device
    t = injected_or(t, lambda: draw_shard(lambda n: torch.randint(
        0, schedule.num_timesteps, (n,), generator=generator, device=dev), bsz), dev)
    noise = injected_or(noise, lambda: draw_shard(lambda n: torch.randn(
        (n,) + z.shape[1:], generator=generator, device=dev), bsz), dev)
    return t, noise


def _eps_step(predict: Callable, schedule: NoiseSchedule, cfg: TeacherConfig) -> Callable:
    """step(state, z, *cond, generator=None, t=None, noise=None): the
    eps-MSE of predict(model, x_noisy, t, *cond), one optimiser step."""

    def step(state: TeacherState, z: torch.Tensor, *cond,
             generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        t, noise = _draws(schedule, z, generator, t, noise)
        eps = predict(state.model, schedule.q_sample(z, t, noise), t, *cond)
        per_sample = torch.mean((eps - noise) ** 2, dim=tuple(range(1, z.dim())))
        loss_simple = torch.mean(per_sample)
        loss = cfg.l_simple_weight * loss_simple
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        full_grads(state.model)
        state.optimizer.step()
        state.step += 1
        return state, {"train/loss_simple": mean_over_ranks(loss_simple.detach()),
                       "train/loss": mean_over_ranks(loss.detach())}

    return step


def make_inpaint_step(dit_apply: Callable, schedule: NoiseSchedule,
                      cfg: TeacherConfig) -> Callable:
    """dit_apply(model, x_cat (B, C + C_concat, T'), t, context) -> eps over
    the z channels; the denoiser is built with in_channels = C + C_concat.
    Returns step(state, z, c_concat, context, generator=None, t=None,
    noise=None) -> (state, metrics)."""
    return _eps_step(lambda m, x, t, c_concat, context: dit_apply(
        m, torch.cat([x, c_concat], dim=1), t, context), schedule, cfg)


def make_order_step(order_dit_apply: Callable, schedule: NoiseSchedule,
                    cfg: TeacherConfig) -> Callable:
    """order_dit_apply(model, x_noisy, t, token_emb, order_index) -> eps.
    Returns step(state, z, token_emb, order_index, generator=None, t=None,
    noise=None) -> (state, metrics)."""
    return _eps_step(order_dit_apply, schedule, cfg)


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    num_classes: int = 527
    learning_rate: float = 1.0e-4
    weight_decay: float = 1.0e-2  # classifier.py:221
    log_steps: int = 10


# (step, model, optimizer), as JAX's ClassifierState has the teacher's fields
ClassifierState = TeacherState


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """The share of rows whose label is among the k largest logits
    (`classifier.py:150-155`)."""
    top = logits.topk(k, dim=-1).indices
    return torch.mean(torch.sum((top == labels[:, None]).float(), dim=-1))


def make_classifier_optimizer(cfg: ClassifierConfig, params):
    """optax.adamw(learning_rate, weight_decay): no clipping, a constant rate."""
    return adamw_chain(params, lambda step: cfg.learning_rate, None, cfg.weight_decay)


def init_classifier_state(model: nn.Module, cfg: ClassifierConfig,
                          optimizer: Optional[Callable] = None) -> ClassifierState:
    """optimizer(params) -> an optimizer, `make_classifier_optimizer` by default."""
    model.train()
    params = list(model.parameters())
    opt = optimizer(params) if optimizer is not None else make_classifier_optimizer(cfg, params)
    return ClassifierState(0, model, opt)


def _metrics(logits: torch.Tensor, targets: torch.Tensor) -> dict:
    return {"acc@1": top_k_accuracy(logits, targets, 1),
            "acc@5": top_k_accuracy(logits, targets, 5)}


def make_classifier_step(classifier_apply: Callable, schedule: NoiseSchedule,
                         cfg: ClassifierConfig) -> Callable:
    """classifier_apply(model, x_noisy, t) -> logits (B, classes). Returns
    step(state, z, targets, generator=None, t_fixed=-1, t=None, noise=None)
    -> (state, metrics): t is t_fixed for every row when t_fixed >= 0, else
    drawn (or injected); only the classifier trains (`classifier.py:
    179-200`)."""

    def step(state: ClassifierState, z: torch.Tensor, targets: torch.Tensor,
             generator: Optional[torch.Generator] = None, t_fixed: int = -1,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        if t_fixed >= 0:
            t = torch.full((z.shape[0],), t_fixed, dtype=torch.long, device=z.device)
        t, noise = _draws(schedule, z, generator, t, noise)
        logits = classifier_apply(state.model, schedule.q_sample(z, t, noise), t)
        targets = targets.long()
        loss = F.cross_entropy(logits.float(), targets)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        full_grads(state.model)
        state.optimizer.step()
        state.step += 1
        metrics = {"train/loss": loss.detach(),
                   **{f"train/{k}": v for k, v in _metrics(logits.detach(), targets).items()}}
        return state, {k: mean_over_ranks(v) for k, v in metrics.items()}

    return step


@torch.no_grad()
def noisy_accuracy_sweep(classifier_apply: Callable, model: nn.Module, z: torch.Tensor,
                         targets: torch.Tensor, schedule: NoiseSchedule,
                         generator: Optional[torch.Generator] = None, log_every_t: int = 100,
                         noises: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """{t: {"acc@1", "acc@5"}} at each t in range(0, T, log_every_t)
    (`classifier.py:202-218`); one noise draw per level, `noises[i]` when
    injected."""
    out = {}
    for i, t_val in enumerate(range(0, schedule.num_timesteps, log_every_t)):
        noise = (noises[i].to(z.device) if noises is not None
                 else torch.randn(z.shape, generator=generator, device=z.device))
        t = torch.full((z.shape[0],), t_val, dtype=torch.long, device=z.device)
        logits = classifier_apply(model, schedule.q_sample(z, t, noise), t)
        out[t_val] = {k: float(v) for k, v in _metrics(logits, targets.long()).items()}
    return out
