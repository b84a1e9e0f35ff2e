"""Teacher LDM training step: the eps-prediction MSE (`audiolcm_tpu/train/
teacher.py`).

`ldm/models/diffusion/ddpm_audio.py:419-508` / `ddpm.py:273-341` with
configs/teacher.yaml: t ~ U[0, 1000), q_sample, the per-sample mean of the
eps MSE (logvar_init 0 and not learned: division by exp(0)), plus
original_elbo_weight (0 by default) times the lvlb-weighted term. Global
norm clip 1.0, AdamW over the DiT at the warm-up schedule. f32, the DiT
built with use_flash=False. t and the noise come from an explicit
torch.Generator unless injected; under torch.distributed each rank keeps
its rows of the global batch's draws (`parallel/mesh.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from audiolcm_torch.diffusion.schedule import NoiseSchedule
from audiolcm_torch.parallel.mesh import draw_shard, mean_over_ranks, unwrap
from audiolcm_torch.train.lcm_distill import (
    OptimizerChain,
    adamw_chain,
    full_grads,
    global_norm,
    injected_or,
    lambda_linear_schedule,
)


@dataclasses.dataclass(frozen=True)
class TeacherConfig:
    learning_rate: float = 1.0e-5  # teacher.yaml base_learning_rate
    warmup_steps: int = 10000
    grad_clip: float = 1.0
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    weight_decay: float = 1.0e-2
    # optional step -> learning rate (base_lr included); None = lambda-linear
    lr_schedule: Optional[Callable[[int], float]] = None


@dataclasses.dataclass
class TeacherState:
    step: int
    model: nn.Module
    optimizer: Any

    def state_dict(self) -> dict:
        return {"step": self.step, "model": unwrap(self.model).state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        unwrap(self.model).load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])


def make_teacher_optimizer(cfg: TeacherConfig, params) -> OptimizerChain:
    return adamw_chain(params, cfg.lr_schedule
                       or lambda_linear_schedule(cfg.learning_rate, cfg.warmup_steps),
                       cfg.grad_clip, cfg.weight_decay)


def lvlb_weights(schedule: NoiseSchedule) -> torch.Tensor:
    """betas^2 / (2 posterior_variance alphas (1 - alphas_cumprod)), entry 0
    set to entry 1 (`ddpm.py:160-167`), float32 on the CPU."""
    f = lambda name: torch.from_numpy(getattr(schedule, name))
    betas, acp = f("betas"), f("alphas_cumprod")
    lvlb = betas ** 2 / (2 * f("posterior_variance") * (1.0 - betas) * (1 - acp))
    lvlb[0] = lvlb[1]
    return lvlb


def make_teacher_step(schedule: NoiseSchedule, cfg: TeacherConfig) -> Callable:
    """Returns step(state, z, context, generator=None, t=None, noise=None)
    -> (state, metrics); the model is called as dit(x, t, context, None).
    metrics: train/loss_simple, train/loss, train/grad_norm (before
    clipping), 0-dim tensors on the device."""

    def lvlb_on(device) -> torch.Tensor:
        return schedule.on_device("lvlb_weights", device, lambda: lvlb_weights(schedule))

    def step(state: TeacherState, z: torch.Tensor, context: torch.Tensor,
             generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        bsz, dev = z.shape[0], z.device
        t = injected_or(t, lambda: draw_shard(lambda n: torch.randint(
            0, schedule.num_timesteps, (n,), generator=generator, device=dev), bsz), dev)
        noise = injected_or(noise, lambda: draw_shard(lambda n: torch.randn(
            (n,) + z.shape[1:], generator=generator, device=dev), bsz), dev)
        x_noisy = schedule.q_sample(z, t, noise)
        eps = state.model(x_noisy, t, context, None)
        per_sample = torch.mean((eps - noise) ** 2, dim=tuple(range(1, z.dim())))
        loss_simple = torch.mean(per_sample)
        loss = cfg.l_simple_weight * loss_simple
        if cfg.original_elbo_weight > 0:
            loss = loss + cfg.original_elbo_weight * torch.mean(lvlb_on(dev)[t] * per_sample)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = global_norm(full_grads(state.model))
        state.optimizer.step()
        state.step += 1
        return state, {"train/loss_simple": mean_over_ranks(loss_simple.detach()),
                       "train/loss": mean_over_ranks(loss.detach()), "train/grad_norm": grad_norm}

    return step


def init_teacher_state(model: nn.Module, cfg: TeacherConfig,
                       optimizer: Optional[Callable] = None) -> TeacherState:
    """optimizer(params) -> an optimizer, `make_teacher_optimizer` by default."""
    model.train()
    params = list(model.parameters())
    opt = optimizer(params) if optimizer is not None else make_teacher_optimizer(cfg, params)
    return TeacherState(0, model, opt)
