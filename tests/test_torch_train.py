"""Port parity: the first trainers (LCM consistency distillation and the
teacher LDM step) and their harness against audiolcm_tpu, f32 CPU, on one
tiny DiT (hidden 32, depth 1).

The steps run with the same draws on both sides (JAX's are recomputed from
its key and injected into the port) and with plain SGD at lr 1
(optax.sgd(1.0) / torch.optim.SGD(lr=1)), so the updated student is the
old one minus the gradients: it, the EMA target and the metrics agree at
atol 1e-5. The shipped optimiser chain (global-norm clip, AdamW, warm-up
schedule) agrees with optax on identical gradients at 1e-6 over 3 steps;
the schedules at 1e-7; the DDIM solver's tables exactly.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolcm_torch.diffusion.lcm import DDIMSolver as TSolver
from audiolcm_torch.diffusion.schedule import NoiseSchedule as TSchedule
from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
from audiolcm_torch.models.dit import ConcatDiT2MLP as TorchDiT
from audiolcm_torch.nn import flash_attention as t_flash
from audiolcm_torch.nn.embeddings import guidance_scale_embedding
from audiolcm_torch.train import ema as t_ema
from audiolcm_torch.train import lcm_distill as t_lcm
from audiolcm_torch.train import logging as t_log
from audiolcm_torch.train import lr_schedules as t_sched
from audiolcm_torch.train import teacher as t_teacher
from audiolcm_torch.train.checkpoints import CheckpointManager, PreemptionSaver
from audiolcm_torch.train.loop import (
    MetricsLogger,
    Trainer,
    device_peak_memory_bytes,
    scale_learning_rate,
)
from audiolcm_tpu.convert import convert_dit
from audiolcm_tpu.diffusion.lcm import DDIMSolver as JSolver
from audiolcm_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from audiolcm_tpu.models.dit import ConcatDiT2MLP as JaxDiT
from audiolcm_tpu.train import ema as j_ema
from audiolcm_tpu.train import lcm_distill as j_lcm
from audiolcm_tpu.train import lr_schedules as j_sched
from audiolcm_tpu.train import teacher as j_teacher
from tests.test_convert import _synthetic_dit_sd
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN = 4, 8, 32, 1, 4, 64
B, T, LC = 2, 8, 2  # batch, latent frames, tokens per context half
ATOL = 1e-5


@pytest.fixture(scope="module")
def dit_sd():
    return {k: v * 0.05 for k, v in
            _synthetic_dit_sd(IN_CH, CTX, HIDDEN, DEPTH, MAX_LEN).items()}


def _torch_dit(sd):
    mod = TorchDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN)  # use_flash=False
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return mod


def _jax_apply():
    model = JaxDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN)
    return lambda p, x, t, ctx, w: model.apply({"params": p}, x, t, ctx, w)


def _as_jax(module):
    """A port module's weights as the JAX DiT's parameter tree."""
    return convert_dit({k: v.detach().numpy() for k, v in module.state_dict().items()},
                       depth=DEPTH)


def _assert_tree_close(got, want, atol=ATOL):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                         atol=atol), got, want)


def _batch(seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, T, IN_CH)).astype(np.float32)
    ctx = rng.standard_normal((B, 2 * LC, CTX)).astype(np.float32)
    uc = rng.standard_normal((1, 2 * LC, CTX)).astype(np.float32)
    return z, ctx, uc


def test_ddim_solver_tables_and_step_match_jax(rng):
    acp = TSchedule.linear().alphas_cumprod
    ts, js = TSolver(acp), JSolver(np.asarray(JSchedule.linear().alphas_cumprod))
    assert ts.step_ratio == js.step_ratio == 20
    np.testing.assert_array_equal(ts.ddim_timesteps.numpy(), js.ddim_timesteps)
    np.testing.assert_array_equal(ts.ddim_alpha_cumprods.numpy(),
                                  np.asarray(js.ddim_alpha_cumprods))
    np.testing.assert_array_equal(ts.ddim_alpha_cumprods_prev.numpy(),
                                  np.asarray(js.ddim_alpha_cumprods_prev))
    x0, eps = (rng.standard_normal((3, T, IN_CH)).astype(np.float32) for _ in range(2))
    idx = np.array([0, 17, 49])
    got = ts.ddim_step(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(idx))
    want = js.ddim_step(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


SCHEDULES = {
    "warmup_cosine": (100, lambda m: m.warmup_cosine(100, 0.01, 1.0, 1e-4, 1000)),
    "warmup_cosine2": (50, lambda m: m.warmup_cosine2([50, 20], [0.1, 0.05], [1.0, 0.5],
                                                      [1e-6, 1e-6], [300, 200])),
    "lambda_linear": (50, lambda m: m.lambda_linear([50, 20], [0.1, 0.05], [1.0, 0.5],
                                                    [1e-6, 1e-6], [300, 200])),
    "build_default": (40, lambda m: m.build_schedule(None, 3e-4, default_warmup=40)),
    "build_cosine": (60, lambda m: m.build_schedule(
        {"target": "ldm.lr_scheduler.LambdaWarmUpCosineScheduler",
         "params": {"warm_up_steps": 60, "lr_min": 0.1, "lr_max": 1.0, "lr_start": 1e-3,
                    "max_decay_steps": 150, "verbosity_interval": 0}}, 2e-4)),
    "lcm_lambda_linear": (30, None),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax_values(name):
    """Steps 0 .. 3 x warm-up: the port's learning rate equals JAX's at
    each count within 1e-7 (both float32)."""
    warm, make = SCHEDULES[name]
    if make is None:
        port, ref = (m.lambda_linear_schedule(5e-4, warm) for m in (t_lcm, j_lcm))
    else:
        port, ref = make(t_sched), make(j_sched)
    for n in range(3 * warm + 1):
        assert isinstance(port(n), float)
        assert abs(port(n) - float(ref(jnp.asarray(n)))) <= 1e-7, n
    with pytest.raises(ValueError, match="unknown lr scheduler"):
        t_sched.build_schedule({"target": "Nope"}, 1.0)


def test_lambda_lr_step_n_is_optax_count_n():
    """LambdaLR over an optimizer built with lr=1.0 applies schedule(n) at
    its n-th step, as optax applies schedule(count)."""
    p = torch.nn.Parameter(torch.zeros(1))
    sched = t_lcm.lambda_linear_schedule(1.0, 4)
    chain = t_lcm.OptimizerChain([p], torch.optim.SGD([p], lr=1.0), sched)
    for n in range(6):
        assert chain.param_groups[0]["lr"] == sched(n)
        p.grad = torch.ones(1)
        chain.step()


def test_ema_update_matches_jax(rng):
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    state_t = t_ema.ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    state_j = j_ema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    for i in range(3):
        new = {k: (v + rng.standard_normal(v.shape) * (i + 1)).astype(np.float32)
               for k, v in params.items()}
        state_t = t_ema.ema_update(state_t, {k: torch.from_numpy(v) for k, v in new.items()})
        state_j = j_ema.ema_update(state_j, {k: jnp.asarray(v) for k, v in new.items()})
    assert state_t.num_updates == int(state_j.num_updates) == 3
    for k in params:
        np.testing.assert_allclose(state_t.params[k].numpy(), np.asarray(state_j.params[k]),
                                   atol=1e-6)
    # on a module: its parameters, by name
    mod = torch.nn.Linear(3, 2)
    st = t_ema.ema_init(mod)
    assert set(st.params) == {"weight", "bias"}
    with torch.no_grad():
        mod.weight.add_(1.0)
    t_ema.ema_update(st, mod, decay=0.5)  # n=1: d = min(0.5, 2/11)
    np.testing.assert_allclose(st.params["weight"].numpy(),
                               mod.weight.detach().numpy() - 2.0 / 11.0, atol=1e-6)


def _jax_distill_draws(key, z_shape, cfg):
    """The draws of JAX's loss_fn, recomputed from its key."""
    r_index, r_noise, r_w = jax.random.split(key, 3)
    index = jax.random.randint(r_index, (z_shape[0],), 0, cfg.num_ddim_timesteps)
    noise = jax.random.normal(r_noise, z_shape)
    w = jax.random.uniform(r_w, (z_shape[0],), minval=cfg.w_min, maxval=cfg.w_max)
    return (torch.from_numpy(np.array(a)) for a in (index, noise, w))


@pytest.mark.parametrize("seed", [2, 7])
def test_lcm_distill_step_matches_jax(dit_sd, monkeypatch, seed):
    """One distillation step, SGD lr 1, the same draws (seed 7 draws t =
    999, seed 2 two mid-grid steps): the updated student (= student -
    grads), the EMA target and both metrics at atol 1e-5.

    The target is moved away from the student first (as the JAX EMA test
    does), so that the consistency gap is far above the pseudo-Huber's c =
    1e-3: at the initial state the gap is ~c, and the loss's curvature 1/c
    turns the f32 rounding of the O(1)-O(30) predictions into ~1e-3 of the
    gradient in either package. Both sides feed the student and the target
    the port's guidance embedding of w: at w in [4, 12] its float32
    sinusoid arguments reach 1.2e4 rad, where one ulp of a frequency moves
    sin by ~1e-3, and torch's float32 exp rounds 15 of the 128 frequencies
    differently from XLA's (torch's is the correctly rounded one at 125 of
    them). The two embeddings are held to each other at 2e-3 here."""
    z, ctx, uc = _batch(1)
    key = jax.random.PRNGKey(seed)
    jcfg = j_lcm.LCMDistillConfig()
    index, noise, w = _jax_distill_draws(key, z.shape, jcfg)
    w_emb = guidance_scale_embedding(w, 256)
    np.testing.assert_allclose(w_emb.numpy(), np.asarray(
        j_lcm.guidance_scale_embedding(jnp.asarray(w.numpy()), 256)), atol=2e-3)
    monkeypatch.setattr(j_lcm, "guidance_scale_embedding",
                        lambda w_, dim: jnp.asarray(w_emb.numpy()))
    rng = np.random.default_rng(5)
    target_sd = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in dit_sd.items()}
    teacher_j = convert_dit(dit_sd, depth=DEPTH)
    state_j = j_lcm.init_train_state(jax.tree.map(jnp.copy, teacher_j), jcfg, optax.sgd(1.0))
    state_j = state_j._replace(target=convert_dit(target_sd, depth=DEPTH))
    step_j = j_lcm.make_lcm_distill_step(_jax_apply(), JSchedule.linear(), jcfg, optax.sgd(1.0))
    state_j, m_j = jax.jit(step_j)(state_j, teacher_j,
                                   j_lcm.Batch(jnp.asarray(z), jnp.asarray(ctx)),
                                   jnp.asarray(uc), key)

    cfg = t_lcm.LCMDistillConfig()
    teacher = _torch_dit(dit_sd).eval().requires_grad_(False)
    state = t_lcm.init_train_state(_torch_dit(dit_sd), cfg,
                                   optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
    state.target.load_state_dict({k: torch.from_numpy(v) for k, v in target_sd.items()})
    step = t_lcm.make_lcm_distill_step(TSchedule.linear(), cfg)
    state, m = step(state, teacher, t_lcm.Batch(torch.from_numpy(z), torch.from_numpy(ctx)),
                    torch.from_numpy(uc), index=index, noise=noise, w=w)
    assert state.step == int(state_j.step) == 1
    assert float(m_j["train/loss"]) > 10 * jcfg.huber_c
    for k in ("train/loss", "train/grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=ATOL)
    _assert_tree_close(_as_jax(state.student), state_j.student)
    _assert_tree_close(_as_jax(state.target), state_j.target)
    assert not any(p.requires_grad for p in state.target.parameters())


def test_lcm_distill_step_draws_from_generator(dit_sd):
    """Without injected draws the step draws from the generator: the same
    seed gives the same step, and the student and target move."""
    z, ctx, uc = (torch.from_numpy(a) for a in _batch(2))
    cfg = t_lcm.LCMDistillConfig(learning_rate=1e-3, warmup_steps=1)
    teacher = _torch_dit(dit_sd).requires_grad_(False)
    losses = []
    for _ in range(2):
        state = t_lcm.init_train_state(_torch_dit(dit_sd), cfg)
        step = t_lcm.make_lcm_distill_step(TSchedule.linear(), cfg)
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            state, m = step(state, teacher, t_lcm.Batch(z, ctx), uc, gen)
        losses.append(float(m["train/loss"]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    w0 = teacher.proj_in.weight
    assert (state.student.proj_in.weight - w0).abs().max() > 0
    assert (state.target.proj_in.weight - w0).abs().max() > 0
    assert state.optimizer.param_groups[0]["lr"] == float(np.float32(cfg.learning_rate))


@pytest.mark.parametrize("elbo", [0.0, 0.5])
def test_teacher_step_matches_jax(dit_sd, elbo):
    """One teacher step, SGD lr 1, the same t and noise; with
    original_elbo_weight 0.5 the lvlb term too."""
    z, ctx, _ = _batch(3)
    key = jax.random.PRNGKey(11)
    jcfg = j_teacher.TeacherConfig(original_elbo_weight=elbo)
    apply = _jax_apply()
    params_j = convert_dit(dit_sd, depth=DEPTH)
    state_j = j_teacher.init_teacher_state(params_j, jcfg, optax.sgd(1.0))
    step_j = j_teacher.make_teacher_step(lambda p, x, t, c, w=None: apply(p, x, t, c, None),
                                         JSchedule.linear(), jcfg, optax.sgd(1.0))
    state_j, m_j = jax.jit(step_j)(state_j, jnp.asarray(z), jnp.asarray(ctx), key)
    r_t, r_noise = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(r_t, (B,), 0, 1000)))
    noise = torch.from_numpy(np.array(jax.random.normal(r_noise, z.shape)))

    cfg = t_teacher.TeacherConfig(original_elbo_weight=elbo)
    state = t_teacher.init_teacher_state(_torch_dit(dit_sd), cfg,
                                         optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
    step = t_teacher.make_teacher_step(TSchedule.linear(), cfg)
    state, m = step(state, torch.from_numpy(z), torch.from_numpy(ctx), t=t, noise=noise)
    for k in ("train/loss_simple", "train/loss", "train/grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, atol=ATOL)
    if elbo:
        assert float(m["train/loss"]) > float(m["train/loss_simple"])
    _assert_tree_close(_as_jax(state.model), state_j.params)


def test_optimizer_chain_matches_optax(rng):
    """clip_by_global_norm(1.0) + adamw(lambda-linear 1e-2 over 2 steps,
    wd 1e-2) on identical gradients, 3 steps: the first clips (norm > 1),
    the others not; parameters at 1e-6. The weight decay of a parameter
    whose gradient is zero (as full_grads fills it) matches optax's."""
    shapes = {"w": (4, 3), "b": (3,), "unused": (2,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32) * (k != "unused")
              for k, s in shapes.items()} for scale in (3.0, 0.1, 0.2)]
    sched = (1e-2, 2)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(j_lcm.lambda_linear_schedule(*sched), weight_decay=1e-2))
    pj = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    chain = t_lcm.adamw_chain(list(pt.values()), t_lcm.lambda_linear_schedule(*sched), 1.0,
                              1e-2)
    norms = []
    for g in grads:
        gj = {k: jnp.asarray(v) for k, v in g.items()}
        norms.append(float(optax.global_norm(gj)))
        updates, opt_state = tx.update(gj, opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k].copy())
        assert float(t_lcm.global_norm([p.grad for p in pt.values()])) == pytest.approx(
            norms[-1], rel=1e-6)
        chain.step()
        for k in shapes:
            np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), atol=1e-6)
    assert norms[0] > 1.0 > norms[1]


def test_lvlb_weights_match_jax():
    js = JSchedule.linear()
    betas, acp = np.asarray(js.betas), np.asarray(js.alphas_cumprod)
    with np.errstate(divide="ignore"):
        want = betas ** 2 / (2 * np.asarray(js.posterior_variance) * (1.0 - betas) * (1 - acp))
    want[0] = want[1]
    np.testing.assert_allclose(t_teacher.lvlb_weights(TSchedule.linear()).numpy(), want,
                               rtol=1e-6)


def test_checkpoint_top_k_interval_and_restore(tmp_path):
    """Top-k by a monitored metric in both modes, the step interval (the
    first save always; forced saves skip the interval), latest and restore
    into a template."""
    for mode, keep in (("min", [2, 4]), ("max", [1, 3])):
        mgr = CheckpointManager(str(tmp_path / mode), max_to_keep=2, monitor="val/loss",
                                mode=mode)
        for step, loss in ((1, 0.9), (2, 0.2), (3, 0.8), (4, 0.1)):
            assert mgr.save(step, {"w": torch.full((2,), float(step))}, {"val/loss": loss})
        assert mgr.all_steps() == keep
    mgr = CheckpointManager(str(tmp_path / "interval"), max_to_keep=3, save_interval_steps=5)
    saved = [s for s in range(1, 13) if mgr.save(s, {"w": torch.zeros(1)})]
    assert saved == [1, 5, 10]
    assert mgr.save(12, {"w": torch.zeros(1)}, force=True)
    assert not mgr.save(12, {"w": torch.zeros(1)}, force=True)  # never twice
    assert mgr.all_steps() == [5, 10, 12] and mgr.latest_step() == 12
    mod = torch.nn.Linear(3, 2)
    mgr.save(15, {"w": mod.state_dict()["weight"], "step": 15})
    back = mgr.restore()
    assert back["step"] == 15 and torch.equal(back["w"], mod.weight.detach())
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_checkpoint_restores_train_state_exactly(tmp_path, dit_sd):
    """A distillation state after two AdamW steps: saved, restored into a
    fresh state, every tensor and the schedule's position equal."""
    z, ctx, uc = (torch.from_numpy(a) for a in _batch(4))
    cfg = t_lcm.LCMDistillConfig(learning_rate=1e-3, warmup_steps=3)
    teacher = _torch_dit(dit_sd).requires_grad_(False)
    state = t_lcm.init_train_state(_torch_dit(dit_sd), cfg)
    step = t_lcm.make_lcm_distill_step(TSchedule.linear(), cfg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, _ = step(state, teacher, t_lcm.Batch(z, ctx), uc, gen)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(state.step, state, {"train/loss": 0.5})
    fresh = mgr.restore(template=t_lcm.init_train_state(_torch_dit(dit_sd), cfg))
    assert fresh.step == 2
    for a, b in ((state.student, fresh.student), (state.target, fresh.target)):
        for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(v, v2)
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["scheduler"]["last_epoch"] == sb["scheduler"]["last_epoch"] == 2
    for i, st in sa["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], sb["optimizer"]["state"][i][k])
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]


def test_preemption_flag_on_sigusr1():
    saver = PreemptionSaver()
    assert not saver.should_save
    if signal.getsignal(signal.SIGUSR1) == saver._handler:
        os.kill(os.getpid(), signal.SIGUSR1)  # the installed handler (main thread)
    else:
        saver._handler(signal.SIGUSR1, None)  # not the main thread: no handler
    assert saver.should_save
    saver.clear()
    assert not saver.should_save


def test_trainer_fit_writes_metrics_and_checkpoints(tmp_path):
    def step_fn(state, batch, generator):
        w = state["w"] - 0.1 * (state["w"] - batch)
        return {"w": w}, {"train/loss": torch.mean((w - batch) ** 2)}

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    trainer = Trainer(step_fn, {"w": torch.zeros(())}, str(tmp_path), checkpoints=mgr,
                      log_every=1, checkpoint_every_steps=100,
                      val_fn=lambda state, epoch: {"val/w": state["w"]})
    trainer.fit(lambda epoch: [torch.tensor(1.0)] * 5, num_epochs=2)
    assert trainer.global_step == 10 and float(trainer.state["w"]) > 0.5
    lines = [json.loads(line) for line in open(os.path.join(str(tmp_path), "metrics.jsonl"))]
    assert sum("train/loss" in line for line in lines) == 10
    epochs = [line for line in lines if "epoch_time_s" in line]
    assert [e["epoch"] for e in epochs] == [0, 1] and all("val/w" in e for e in epochs)
    assert mgr.all_steps() == [5, 10]
    assert device_peak_memory_bytes() is None  # no card here
    assert abs(scale_learning_rate(3e-6, 8, 8) - 1.92e-4) < 1e-12


def test_trainer_saves_on_exception(tmp_path):
    calls = []

    def step_fn(state, batch, generator):
        if len(calls) >= 2:
            raise RuntimeError("boom")
        calls.append(1)
        return state, {}

    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=100)
    trainer = Trainer(step_fn, {"w": torch.zeros(())}, str(tmp_path), checkpoints=mgr)
    with pytest.raises(RuntimeError, match="boom"):
        trainer.fit(lambda e: [1, 2, 3, 4], num_epochs=1)
    assert mgr.latest_step() == 2  # 'last' saved before dying, off the interval


def test_sample_logger_writes_mels_and_port_vocoded_wavs(tmp_path):
    torch.manual_seed(0)
    voc = BigVGAN(BigVGANConfig(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                                upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                                resblock_dilation_sizes=((1, 3),))).eval()
    tb = t_log.make_logger("tensorboard", str(tmp_path / "tb"))
    assert tb.active  # tensorboardX is installed here
    tb.scalars(3, {"train/loss": torch.tensor(1.5), "names": ["skipped"]})
    logger = t_log.AudioSampleLogger(str(tmp_path), vocode_fn=t_log.bigvgan_vocode_fn(voc),
                                     max_items=2, tb=tb)
    mels = np.random.default_rng(0).standard_normal((3, 16, 8)).astype(np.float32) * 4
    outdir = logger(mels, step=10, split="val")
    tb.close()
    files = sorted(os.listdir(outdir))
    assert files == ["sample_0.npy", "sample_0.wav", "sample_1.npy", "sample_1.wav"]
    saved = np.load(os.path.join(outdir, "sample_0.npy"))
    np.testing.assert_array_equal(saved, np.clip(mels[0], -5.0, 1.5).T)
    from scipy.io import wavfile

    sr, wav = wavfile.read(os.path.join(outdir, "sample_1.wav"))
    assert sr == 16000 and wav.shape == (16 * 8,)
    assert os.listdir(str(tmp_path / "tb"))


def test_missing_backend_warns_and_no_ops(tmp_path, capsys):
    """wandb is not installed here: one loud warning, then a no-op logger."""
    lg = t_log.make_logger("wandb", str(tmp_path))
    assert not lg.active
    lg.scalars(1, {"a": 1.0})
    lg.close()
    assert "WARNING: wandb logging disabled" in capsys.readouterr().out
    MetricsLogger(str(tmp_path)).log(1, {"a": torch.tensor(2.0), "b": "x"})
    assert json.loads(open(tmp_path / "metrics.jsonl").read()) == {"step": 1, "a": 2.0,
                                                                   "b": "x"}


def test_flash_guard_condition():
    """flash_attention raises on a CUDA tensor that autograd would record
    (the kernel has no backward); the condition, held here on the CPU."""
    q = torch.zeros(1, 1, 4, 8)
    qg = q.clone().requires_grad_(True)
    assert t_flash.records_grad(q, qg, q)
    assert not t_flash.records_grad(q, q, q)
    with torch.no_grad():
        assert not t_flash.records_grad(qg, qg, qg)
    with torch.inference_mode():
        assert not t_flash.records_grad(qg, qg, qg)
    # on the CPU the plain version runs and keeps the gradient
    out = t_flash.flash_attention(qg, qg, qg, 0.5)
    out.sum().backward()
    assert qg.grad is not None
