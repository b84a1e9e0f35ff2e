"""LCM consistency-distillation training step (`audiolcm_tpu/train/
lcm_distill.py`).

`ldm/models/diffusion/lcm_audio.py:456-476,618-698,996-1024` with
configs/audiolcm.yaml:
  * three DiTs: the frozen teacher, the trained student, and the EMA target
    (rate 0.95, updated every step);
  * t on the 50-step DDIM grid; guidance w ~ U[4, 12], its 256-d Fourier
    embedding fed to the student and the target only;
  * the teacher's classifier-free guidance in both x0 and eps space, one
    DDIM solver step to x_prev, the target's consistency prediction at t - k;
  * the pseudo-Huber loss sqrt(d^2 + c^2) - c, c = 1e-3;
  * global-norm clip 1.0, then AdamW on the student, then the warm-up
    schedule, then the target's EMA.

f32 throughout, the DiTs built with use_flash=False (the flash kernel has
no backward), state dicts in the reference layout (`convert.py` carries
weights from JAX parameters). The step draws t's grid index, the noise and
w from an explicit torch.Generator unless the caller injects them, as the
samplers take x_T and noise. The uncond context is computed once by the
caller and passed in.

Under torch.distributed the student may be wrapped in DDP
(`parallel/mesh.py`): each rank draws the global batch's draws and keeps
its rows, and the reported loss is the mean over the ranks.

A torch optimizer holds its state and is bound to the student's
parameters, so where the JAX step takes an optax transform, the port's
state holds the optimizer: `init_train_state(..., optimizer=factory)` with
factory(params) -> an optimizer (`make_optimizer` by default; the tests pass
plain SGD).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Iterable, List, NamedTuple, Optional

import torch
from torch import nn

from audiolcm_torch.diffusion.lcm import DDIMSolver, boundary_scalings
from audiolcm_torch.diffusion.schedule import NoiseSchedule
from audiolcm_torch.nn.embeddings import guidance_scale_embedding
from audiolcm_torch.parallel.mesh import draw_shard, mean_over_ranks, unwrap


@dataclasses.dataclass(frozen=True)
class LCMDistillConfig:
    num_ddim_timesteps: int = 50
    w_min: float = 4.0
    w_max: float = 12.0
    huber_c: float = 1.0e-3
    ema_decay: float = 0.95  # target <- 0.95*target + 0.05*student
    learning_rate: float = 3.0e-6  # base_lr; the caller applies ngpu*bs scaling
    warmup_steps: int = 10000
    weight_decay: float = 1.0e-2  # torch.optim.AdamW's default
    grad_clip: float = 1.0  # lightning.trainer.gradient_clip_val
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1.0e-8
    # optional step -> learning rate (train/lr_schedules.build_schedule,
    # base_lr included); None = the shipped lambda-linear warm-up
    lr_schedule: Optional[Callable[[int], float]] = None


class Batch(NamedTuple):
    """One training batch: VAE-encoded, scaled latents and their contexts."""

    z: torch.Tensor  # (B, T, C)
    context: torch.Tensor  # (B, 154, ctx_dim)


def lambda_linear_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    """`ldm/lr_scheduler.py:81-97` with the shipped f_start=1e-6,
    f_max=f_min=1: a ramp from ~0 to base_lr over warm-up, then constant;
    float32, as optax evaluates it."""

    def fn(step) -> float:
        n = torch.tensor(float(step), dtype=torch.float32)
        frac = torch.clamp(n / warmup_steps, max=1.0)
        return float(base_lr * (1.0e-6 + (1.0 - 1.0e-6) * frac))

    return fn


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the square root of the sum of every element's
    square, as a 0-dim tensor on the tensors' device (no host sync)."""
    return torch.stack([torch.sum(t.float() ** 2) for t in tensors]).sum().sqrt()


def clip_by_global_norm_(tensors: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: scale the tensors by
    max_norm / norm when their global norm exceeds max_norm; returns the
    norm before clipping."""
    norm = global_norm(tensors)
    torch._foreach_mul_(tensors, torch.clamp(max_norm / norm, max=1.0))
    return norm


class OptimizerChain:
    """optax.chain(clip_by_global_norm(max_norm), <optimizer at schedule>)
    on torch parameters: `step()` clips the gradients, steps `optimizer`
    (built with lr=1.0) at the schedule's learning rate through LambdaLR,
    and advances the schedule. `state_dict` holds the optimizer's and the
    schedule's state."""

    def __init__(self, params: Iterable[nn.Parameter], optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 max_norm: Optional[float] = None):
        self.params = list(params)
        self.optimizer = optimizer
        self.max_norm = max_norm
        self.scheduler = (torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
                          if schedule is not None else None)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        if self.max_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params if p.grad is not None],
                                 self.max_norm)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": None if self.scheduler is None else self.scheduler.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])


def adamw_chain(params: Iterable[nn.Parameter], schedule: Callable[[int], float],
                grad_clip: float, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1.0e-8) -> OptimizerChain:
    """clip_by_global_norm(grad_clip) + adamw(schedule, b1, b2, eps,
    weight_decay): decoupled decay on the parameter before the update, as
    optax.adamw and torch.optim.AdamW both apply it."""
    params = list(params)
    adamw = torch.optim.AdamW(params, lr=1.0, betas=(b1, b2), eps=eps,
                              weight_decay=weight_decay)
    return OptimizerChain(params, adamw, schedule, grad_clip)


def make_optimizer(cfg: LCMDistillConfig, params: Iterable[nn.Parameter]) -> OptimizerChain:
    return adamw_chain(params, cfg.lr_schedule
                       or lambda_linear_schedule(cfg.learning_rate, cfg.warmup_steps),
                       cfg.grad_clip, cfg.weight_decay, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps)


def full_grads(module: nn.Module) -> List[torch.Tensor]:
    """Every trainable parameter's gradient, a zero tensor where the loss
    did not reach it: jax.grad's tree, so that weight decay and the norm
    see every parameter as in the JAX step."""
    for p in module.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in module.parameters() if p.requires_grad]


def injected_or(given: Optional[torch.Tensor], make: Callable[[], torch.Tensor], device):
    """The injected draw on `device`, or make()'s."""
    return given.to(device) if given is not None else make()


def _dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


@dataclasses.dataclass
class TrainState:
    step: int
    student: nn.Module
    target: nn.Module
    optimizer: Any  # OptimizerChain, or any torch optimizer over the student

    def state_dict(self) -> dict:
        return {"step": self.step, "student": unwrap(self.student).state_dict(),
                "target": self.target.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        unwrap(self.student).load_state_dict(sd["student"])
        self.target.load_state_dict(sd["target"])
        self.optimizer.load_state_dict(sd["optimizer"])


def init_train_state(student: nn.Module, cfg: LCMDistillConfig,
                     optimizer: Optional[Callable] = None) -> TrainState:
    """The student (initialised from the teacher's weights by the caller);
    the target a frozen copy of it (`lcm_audio.py:107-114`); the optimizer
    optimizer(student params), `make_optimizer` by default."""
    target = copy.deepcopy(student).requires_grad_(False).eval()
    student.train()
    params = list(student.parameters())
    opt = optimizer(params) if optimizer is not None else make_optimizer(cfg, params)
    return TrainState(0, student, target, opt)


def make_lcm_distill_step(schedule: NoiseSchedule, cfg: LCMDistillConfig) -> Callable:
    """Returns step(state, teacher, batch, uncond_context, generator=None,
    index=None, noise=None, w=None) -> (state, metrics), updating the
    state's student, optimizer and target in place. teacher, student and
    target are DiTs called as dit(x, t, context, w_cond) -> eps. index (B,)
    on the grid, noise (like z) and w (B,) replace the draws from
    `generator`. metrics: train/loss and train/grad_norm (the global norm
    before clipping), 0-dim tensors on the device."""
    solvers = {}

    def solver_on(device) -> DDIMSolver:
        if device not in solvers:
            solvers[device] = DDIMSolver(schedule.alphas_cumprod, schedule.num_timesteps,
                                         cfg.num_ddim_timesteps, device=device)
        return solvers[device]

    def step(state: TrainState, teacher: nn.Module, batch: Batch, uncond_ctx: torch.Tensor,
             generator: Optional[torch.Generator] = None, index: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, w: Optional[torch.Tensor] = None):
        z, context = batch.z, batch.context
        bsz, dev, nd = z.shape[0], z.device, z.dim()
        solver = solver_on(dev)
        index = injected_or(index, lambda: draw_shard(lambda n: torch.randint(
            0, cfg.num_ddim_timesteps, (n,), generator=generator, device=dev), bsz), dev)
        noise = injected_or(noise, lambda: draw_shard(lambda n: torch.randn(
            (n,) + z.shape[1:], generator=generator, device=dev), bsz), dev)
        w = injected_or(w, lambda: cfg.w_min + (cfg.w_max - cfg.w_min) * draw_shard(
            lambda n: torch.rand((n,), generator=generator, device=dev), bsz), dev)
        t = solver.ddim_timesteps[index]
        t_prev = torch.clamp(t - solver.step_ratio, min=0)
        c_skip_s, c_out_s = (_dims(c, nd) for c in boundary_scalings(t))
        c_skip, c_out = (_dims(c, nd) for c in boundary_scalings(t_prev))
        x_noisy = schedule.q_sample(z, t, noise)
        w_emb = guidance_scale_embedding(w, 256)
        w_b = _dims(w.to(torch.float32), nd)

        with torch.no_grad():
            # teacher CFG in x0 and eps space + one DDIM step
            eps_c = teacher(x_noisy, t, context, None)
            eps_u = teacher(x_noisy, t, uncond_ctx.expand_as(context), None)
            x0_c = schedule.predict_start_from_noise(x_noisy, t, eps_c)
            x0_u = schedule.predict_start_from_noise(x_noisy, t, eps_u)
            pred_x0 = x0_c + w_b * (x0_c - x0_u)
            pred_noise = eps_c + w_b * (eps_c - eps_u)
            x_prev = solver.ddim_step(pred_x0, pred_noise, index)
            # target-net consistency prediction at t - k
            eps_target = state.target(x_prev, t_prev, context, w_emb)
            x0_target = schedule.predict_start_from_noise(x_prev, t_prev, eps_target)
            target = c_skip * x_prev + c_out * x0_target

        eps_student = state.student(x_noisy, t, context, w_emb)
        x0_student = schedule.predict_start_from_noise(x_noisy, t, eps_student)
        model_pred = c_skip_s * x_noisy + c_out_s * x0_student
        c = cfg.huber_c
        diff = model_pred.to(torch.float32) - target.to(torch.float32)
        loss = torch.mean(torch.sqrt(diff ** 2 + c ** 2) - c)

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = global_norm(full_grads(state.student))
        state.optimizer.step()
        with torch.no_grad():  # the target's EMA at rate 0.95 (`lcm_audio.py:1021-1024`)
            tgt = list(state.target.parameters())
            torch._foreach_mul_(tgt, cfg.ema_decay)
            torch._foreach_add_(tgt, list(state.student.parameters()), alpha=1.0 - cfg.ema_decay)
        state.step += 1
        return state, {"train/loss": mean_over_ranks(loss.detach()), "train/grad_norm": grad_norm}

    return step
