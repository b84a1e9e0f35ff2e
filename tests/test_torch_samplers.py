"""Port parity: the noise-schedule tables, DDIM and PLMS against
audiolcm_tpu.diffusion (f32 sampler state).

torch cannot reproduce jax.random, so the JAX draws are recomputed exactly
as the JAX samplers make them and injected into the port's samplers:
  DDIM: split(rng) -> (rng, init): x_T = normal(init); steps = split(rng, n)
        for the n points of the timestep grid: step i's noise =
        normal(steps[i]), its q_sample noise = normal(fold_in(steps[i], 1));
  PLMS: split(rng) -> (rng, init): x_T = normal(init);
        split(rng, 2S).reshape(S, 2, -1) -> two draws per step.
Tolerance rtol 1e-5 / atol 2e-5, the LCM sampler's bar
(tests/test_torch_lcm.py:55-57): 1/sqrt(alpha) at the first step scales
rounding by up to ~15x.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.diffusion import ddim as t_ddim
from audiolcm_torch.diffusion import plms as t_plms
from audiolcm_torch.diffusion.schedule import NoiseSchedule as TSchedule
from audiolcm_tpu.diffusion import ddim as j_ddim
from audiolcm_tpu.diffusion import plms as j_plms
from audiolcm_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

SHAPE = (2, 6, 3)  # (B, T, C)
CTX = 5


@pytest.mark.parametrize("v_posterior", [0.0, 0.1])
def test_schedule_tables_match_jax(v_posterior):
    """Every table, computed in float64 and stored as float32, equals JAX's."""
    ts, js = TSchedule.linear(v_posterior=v_posterior), JSchedule.linear(v_posterior=v_posterior)
    for f in dataclasses.fields(JSchedule):
        got, want = getattr(ts, f.name), np.asarray(getattr(js, f.name))
        assert got.dtype == np.float32, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_schedule_helpers_match_jax():
    rng = np.random.default_rng(0)
    x0, xt, eps = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3))
    t = np.array([0, 731], dtype=np.int32)
    ts, js = TSchedule.linear(), JSchedule.linear()
    T = lambda a: torch.from_numpy(a)
    J = jnp.asarray
    pairs = [
        (ts.q_sample(T(x0), T(t), T(eps)), js.q_sample(J(x0), J(t), J(eps))),
        (ts.predict_start_from_noise(T(xt), T(t), T(eps)),
         js.predict_start_from_noise(J(xt), J(t), J(eps))),
        (ts.predict_eps_from_xstart(T(xt), T(t), T(x0)),
         js.predict_eps_from_xstart(J(xt), J(t), J(x0))),
        *zip(ts.q_posterior(T(x0), T(xt), T(t)), js.q_posterior(J(x0), J(xt), J(t))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(np.asarray(want), got.shape),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps", [4, 25, 100, 200])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_timesteps_and_tables_match_jax(steps, eta):
    np.testing.assert_array_equal(t_ddim.make_ddim_timesteps(steps),
                                  j_ddim.make_ddim_timesteps(steps))
    got = t_ddim._tables(TSchedule.linear(), steps, eta)
    want = j_ddim._tables(JSchedule.linear(), steps, eta)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].max() <= 999  # the +1 grid is clipped at N - 1


def _denoisers(seed=3):
    """A toy eps model of (x, t, context) with the same f32 arithmetic on
    both sides."""
    proj = np.random.default_rng(seed).standard_normal((CTX, SHAPE[2])).astype(np.float32) * 0.3

    def j_fn(x, t, ctx):
        return jnp.tanh(0.7 * x + t[:, None, None] / 1000.0 + (ctx.mean(1) @ proj)[:, None, :])

    def t_fn(x, t, ctx):
        return torch.tanh(0.7 * x + t[:, None, None] / 1000.0
                          + (ctx.mean(1) @ torch.from_numpy(proj))[:, None, :])

    return j_fn, t_fn


def _contexts():
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((SHAPE[0], 4, CTX)).astype(np.float32)
    uncond = rng.standard_normal((1, 4, CTX)).astype(np.float32)
    return cond, uncond


def _normal(key):
    return np.array(jax.random.normal(key, SHAPE, dtype=jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("eta,cfg,masked", [(0.0, True, False), (0.5, True, False),
                                            (0.5, False, False), (0.0, True, True)])
def test_ddim_sample_matches_jax_with_injected_draws(eta, cfg, masked):
    """S = 6 gives the grid range(0, 1000, 166) + 1: 7 steps, as in JAX."""
    steps = 6
    j_fn, t_fn = _denoisers()
    cond, uncond = _contexts()
    config = dict(num_steps=steps, eta=eta, guidance_scale=5.0 if cfg else 1.0)
    mask = x0 = None
    if masked:
        mask = np.zeros(SHAPE, np.float32)
        mask[:, :3] = 1.0
        x0 = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    golden = j_ddim.ddim_sample(
        j_fn, JSchedule.linear(), rng, SHAPE, jnp.asarray(cond), jnp.asarray(uncond),
        j_ddim.DDIMConfig(**config), mask=None if mask is None else jnp.asarray(mask),
        x0=None if x0 is None else jnp.asarray(x0))
    r, init = jax.random.split(rng)
    keys = jax.random.split(r, len(j_ddim.make_ddim_timesteps(steps)))  # 7 for S = 6
    noise = np.stack([_normal(k) for k in keys])
    mask_noise = np.stack([_normal(jax.random.fold_in(k, 1)) for k in keys])
    T = lambda a: None if a is None else torch.from_numpy(a)
    out = t_ddim.ddim_sample(
        t_fn, TSchedule.linear(), SHAPE, T(cond), T(uncond), t_ddim.DDIMConfig(**config),
        x_T=T(_normal(init)), noise=T(noise), mask=T(mask), x0=T(x0),
        mask_noise=T(mask_noise) if masked else None)
    assert out.dtype == torch.float32
    _close(out, golden)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_plms_sample_matches_jax_with_injected_draws(eta):
    """5 steps run the whole order ramp: Euler, AB2, AB3 and AB4 twice."""
    steps = 5
    j_fn, t_fn = _denoisers(4)
    cond, uncond = _contexts()
    config = dict(num_steps=steps, eta=eta, guidance_scale=3.0)
    rng = jax.random.PRNGKey(5)
    golden = j_plms.plms_sample(j_fn, JSchedule.linear(), rng, SHAPE, jnp.asarray(cond),
                                jnp.asarray(uncond), j_ddim.DDIMConfig(**config))
    r, init = jax.random.split(rng)
    keys = jax.random.split(r, 2 * steps).reshape(steps, 2, -1)
    noise = np.stack([np.stack([_normal(keys[i, j]) for j in range(2)]) for i in range(steps)])
    out = t_plms.plms_sample(t_fn, TSchedule.linear(), SHAPE, torch.from_numpy(cond),
                             torch.from_numpy(uncond), t_ddim.DDIMConfig(**config),
                             x_T=torch.from_numpy(_normal(init)), noise=torch.from_numpy(noise))
    _close(out, golden)


def test_samplers_count_model_calls_and_draw_from_generator():
    """DDIM calls the model once per step and PLMS once more at step 0,
    each call batch-doubled under CFG; without draws passed in, the same
    generator seed gives the same sample and another seed another."""
    calls = []

    def fn(x, t, ctx):
        calls.append(x.shape[0])
        return 0.5 * x + 0.01 * ctx.mean()

    cond, uncond = (torch.from_numpy(a) for a in _contexts())
    cfg = t_ddim.DDIMConfig(num_steps=5, eta=0.5, guidance_scale=5.0)
    for sampler, n in ((t_ddim.ddim_sample, 5), (t_plms.plms_sample, 6)):
        calls.clear()
        run = lambda seed: sampler(fn, TSchedule.linear(), SHAPE, cond, uncond, cfg,
                                   generator=torch.Generator().manual_seed(seed))
        a = run(1)
        assert calls == [2 * SHAPE[0]] * n
        assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
