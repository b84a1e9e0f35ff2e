"""Port parity: AutoencoderKL1D (encode_moments, decode, forward) and
DiagonalGaussian against audiolcm_tpu.models.vae1d (f32 CPU), with
attention in the down and up levels as well as the mid-blocks.

JAX params are drawn from a numpy seed at the init's shapes (non-zero
biases and norm affines) and reach the port through convert.from_jax.
atol 2e-5 (ROADMAP f32 bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolcm_torch.convert import assign_state_dict, vae_from_jax
from audiolcm_torch.models.vae1d import AutoencoderKL1D as TorchVAE
from audiolcm_torch.models.vae1d import VAEConfig as TVAEConfig
from audiolcm_tpu.models.vae1d import AutoencoderKL1D as JaxVAE
from audiolcm_tpu.models.vae1d import VAEConfig as JVAEConfig
from tests.test_torch_text import random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

CFG = dict(in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_layers=(0, 1), down_layers=(0,), kernel_size=5, z_channels=4, embed_dim=4)


def test_vae_decode_matches_jax(rng):
    jmodel = JaxVAE(JVAEConfig(**CFG))
    key = jax.random.PRNGKey(0)
    params = random_params(
        jax.eval_shape(lambda: jmodel.init(key, jnp.zeros((1, 8, 8)), key))["params"], 4)
    z = rng.standard_normal((2, 6, 4)).astype(np.float32)
    golden = jmodel.apply({"params": params}, jnp.asarray(z), method=JaxVAE.decode)
    port = assign_state_dict(TorchVAE(TVAEConfig(**CFG)), vae_from_jax(params))
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z))
    assert out.shape == (2, 12, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


def _vae_pair(seed):
    """The JAX VAE with random params and the port's VAE loaded from them."""
    jmodel = JaxVAE(JVAEConfig(**CFG))
    key = jax.random.PRNGKey(0)
    params = random_params(
        jax.eval_shape(lambda: jmodel.init(key, jnp.zeros((1, 8, 8)), key))["params"], seed)
    return jmodel, params, assign_state_dict(TorchVAE(TVAEConfig(**CFG)), vae_from_jax(params))


def test_vae_encode_moments_matches_jax(rng):
    """The encoder (configured kernel 5 in its res-blocks, attention in
    both levels and the mid-block, pad-(0, 1) stride-2 downsample) and
    quant_conv, at an even and an odd length."""
    jmodel, params, port = _vae_pair(5)
    for t in (12, 11):
        x = rng.standard_normal((2, t, 8)).astype(np.float32)
        golden = jmodel.apply({"params": params}, jnp.asarray(x), method=JaxVAE.encode_moments)
        with torch.no_grad():
            out = port.encode_moments(torch.from_numpy(x))
        assert out.shape == golden.shape == (2, t // 2, 8)
        np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


def test_diagonal_gaussian_matches_jax(rng):
    """mean/logvar split, logvar clipped to [-30, 20], std, var, mode, kl,
    nll, and a sample from the same normal draw (numpy) on both sides."""
    from audiolcm_torch.models.vae1d import DiagonalGaussian as TDG
    from audiolcm_tpu.models.vae1d import DiagonalGaussian as JDG

    moments = rng.standard_normal((2, 6, 8)).astype(np.float32)
    moments[0, 0, 4], moments[1, 2, 5] = 40.0, -50.0  # beyond both clip bounds
    eps = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jd, td = JDG(jnp.asarray(moments)), TDG(torch.from_numpy(moments))
    for name in ("mean", "logvar", "std", "var"):
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    np.testing.assert_allclose(td.kl().numpy(), np.asarray(jd.kl()), rtol=1e-5)
    sample = td.sample(noise=torch.from_numpy(eps))
    np.testing.assert_allclose(sample.numpy(), np.asarray(jd.mean + jd.std * jnp.asarray(eps)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.nll(sample).numpy(), np.asarray(jd.nll(jnp.asarray(sample))),
                               rtol=1e-5)
    draw = td.sample(torch.Generator().manual_seed(0))
    assert draw.shape == (2, 6, 4) and not torch.equal(draw, td.mode())


def test_vae_forward_matches_jax(rng):
    """forward with sample_posterior=False: decode(mode) and the posterior."""
    jmodel, params, port = _vae_pair(6)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    recon_j, post_j = jmodel.apply({"params": params}, jnp.asarray(x), jax.random.PRNGKey(1),
                                   sample_posterior=False)
    with torch.no_grad():
        recon, post = port(torch.from_numpy(x), sample_posterior=False)
    assert recon.shape == (2, 12, 8)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-5)
    np.testing.assert_allclose(post.kl().numpy(), np.asarray(post_j.kl()), rtol=1e-4)
