"""Port parity: the LCM sampler against audiolcm_tpu.diffusion.lcm (f32).

torch cannot reproduce jax.random, so the JAX draws are recomputed exactly
as lcm_sample makes them (split(rng) -> init; split(rng, S) per step) and
injected into the port's sampler. atol 2e-5 (ROADMAP f32 bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolcm_torch.diffusion import lcm as t_lcm
from audiolcm_torch.diffusion.schedule import NoiseSchedule as TSchedule
from audiolcm_tpu.diffusion import lcm as j_lcm
from audiolcm_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)


def test_timesteps_and_schedule():
    np.testing.assert_array_equal(t_lcm.lcm_inference_timesteps(2), [999, 499])
    for s in (1, 2, 4, 8):
        np.testing.assert_array_equal(t_lcm.lcm_inference_timesteps(s),
                                      j_lcm.lcm_inference_timesteps(s))
    np.testing.assert_array_equal(TSchedule.linear().alphas_cumprod,
                                  np.asarray(JSchedule.linear().alphas_cumprod))


def test_boundary_scalings():
    t = np.array([0, 1, 499, 999], dtype=np.float32)
    for got, want in zip(t_lcm.boundary_scalings(torch.from_numpy(t)),
                         j_lcm.boundary_scalings(jnp.asarray(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_lcm_sample_matches_jax_with_injected_draws():
    shape, cfg = (2, 6, 3), j_lcm.LCMConfig()
    tcfg = t_lcm.LCMConfig()
    proj = np.random.default_rng(3).standard_normal((256, 3)).astype(np.float32) * 0.01

    def j_denoise(x, t, w_emb):
        return jnp.tanh(0.7 * x + t[:, None, None] / 1000.0 + (w_emb @ proj)[:, None, :])

    def t_denoise(x, t, w_emb):
        return torch.tanh(0.7 * x + t[:, None, None] / 1000.0
                          + (w_emb @ torch.from_numpy(proj))[:, None, :])

    rng = jax.random.PRNGKey(7)
    golden = j_lcm.lcm_sample(j_denoise, JSchedule.linear(), rng, shape, cfg)
    r, init = jax.random.split(rng)
    x_T = np.array(jax.random.normal(init, shape, dtype=jnp.float32))
    noise = np.stack([np.array(jax.random.normal(k, shape, dtype=jnp.float32))
                      for k in jax.random.split(r, cfg.num_inference_steps)])
    out = t_lcm.lcm_sample(t_denoise, TSchedule.linear(), shape, tcfg,
                           x_T=torch.from_numpy(x_T), noise=torch.from_numpy(noise))
    # x0 = (x - sqrt(1-a)eps)/sqrt(a) at t=999 scales by ~15, so the latent
    # reaches |13|: f32 rounding there is ~1e-6 relative (rtol 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), rtol=1e-5, atol=2e-5)


def test_lcm_sample_draws_from_generator():
    """Without x_T/noise the draws come from the passed generator: the same
    seed gives the same latent, another seed another."""
    fn = lambda x, t, w: 0.5 * x
    run = lambda seed: t_lcm.lcm_sample(fn, TSchedule.linear(), (1, 4, 2),
                                        generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
