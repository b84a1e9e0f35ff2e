"""Port parity: audiolcm_torch.nn against audiolcm_tpu.nn, f32 on the CPU.

Inputs and weights are drawn with numpy from a seed and handed to both
sides. Tolerance is the ROADMAP's f32 bar (atol 2e-5) unless a test says
otherwise and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.nn import attention as t_attn
from audiolcm_torch.nn import convff as t_convff
from audiolcm_torch.nn import embeddings as t_emb
from audiolcm_torch.nn import resample as t_res
from audiolcm_torch.nn import resample_cf as t_rcf
from audiolcm_torch.nn import snake as t_snake
from audiolcm_tpu.nn import attention as j_attn
from audiolcm_tpu.nn import convff as j_convff
from audiolcm_tpu.nn import embeddings as j_emb
from audiolcm_tpu.nn import resample as j_res
from audiolcm_tpu.nn import resample_cf as j_rcf
from audiolcm_tpu.nn import snake as j_snake
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

ATOL = 2e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def test_timestep_and_guidance_embeddings():
    """Sinusoids of arguments up to ~1e3 rad: one f32 ulp of the argument
    (6e-5 at 999) moves sin/cos by as much, so atol is 1e-4 here."""
    t = np.array([0, 1, 499, 999], dtype=np.int32)
    w = np.array([0.0, 4.0, 11.5], dtype=np.float32)
    for dim in (256, 255):
        np.testing.assert_allclose(
            t_emb.timestep_embedding(torch.from_numpy(t), dim).numpy(),
            _np(j_emb.timestep_embedding(jnp.asarray(t), dim)), atol=1e-4)
    # guidance: w*1000 reaches 1.15e4 rad; same ulp argument, atol 1e-3
    np.testing.assert_allclose(
        t_emb.guidance_scale_embedding(torch.from_numpy(w), 256).numpy(),
        _np(j_emb.guidance_scale_embedding(jnp.asarray(w), 256)), atol=1e-3)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_self_attention(rng, fuse_qkv, use_flash):
    """use_flash=True: the JAX Pallas kernel in interpret mode against the
    port's flash path (its plain version on the CPU), with the chunk views
    of the fused projection under fuse_qkv."""
    b, t, c, heads, hd = 2, 9, 16, 4, 4
    inner = heads * hd
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = {n: rng.standard_normal((c, inner)).astype(np.float32) * 0.3 for n in "qkv"}
    wo = rng.standard_normal((inner, c)).astype(np.float32) * 0.3
    bo = rng.standard_normal(c).astype(np.float32)
    jp = {f"to_{n}": {"kernel": w[n]} for n in "qkv"}
    jp["to_out"] = {"kernel": wo, "bias": bo}
    if fuse_qkv:
        jp = j_attn.fuse_attention_params(jp)
    golden = j_attn.MultiHeadSelfAttention(heads, hd, use_flash, fuse_qkv).apply(
        {"params": jp}, jnp.asarray(x))
    sd = {f"to_{n}.weight": _t(w[n].T) for n in "qkv"}
    sd.update({"to_out.0.weight": _t(wo.T), "to_out.0.bias": _t(bo)})
    if fuse_qkv:
        sd = t_attn.fuse_qkv_state_dict(sd)
    mod = t_attn.MultiHeadSelfAttention(c, heads, hd, use_flash, fuse_qkv)
    mod.load_state_dict(sd)
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), _np(golden), atol=ATOL)


def test_conv_geglu_feed_forward(rng):
    b, t, c, mult = 2, 12, 8, 2
    inner = c * mult
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    wp = rng.standard_normal((9, c, 2 * inner)).astype(np.float32) * 0.2
    bp = rng.standard_normal(2 * inner).astype(np.float32) * 0.1
    wo = rng.standard_normal((9, inner, c)).astype(np.float32) * 0.2
    bo = rng.standard_normal(c).astype(np.float32) * 0.1
    golden = j_convff.Conv1dGEGLUFeedForward(c, mult).apply(
        {"params": {"proj": {"kernel": wp, "bias": bp}, "out": {"kernel": wo, "bias": bo}}},
        jnp.asarray(x))
    mod = t_convff.Conv1dGEGLUFeedForward(c, mult)
    mod.load_state_dict({"net.0.proj.weight": _t(wp.transpose(2, 1, 0)), "net.0.proj.bias": _t(bp),
                         "net.2.weight": _t(wo.transpose(2, 1, 0)), "net.2.bias": _t(bo)})
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), _np(golden), atol=ATOL)


def test_fast_cos_and_snake(rng):
    v = np.concatenate([np.linspace(-60, 60, 4001), rng.standard_normal(500) * 300]).astype(np.float32)
    np.testing.assert_allclose(t_snake.fast_cos(_t(v)).numpy(), _np(j_snake.fast_cos(jnp.asarray(v))),
                               atol=ATOL)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    a, b = np.exp(rng.standard_normal(5) * 0.5).astype(np.float32), np.exp(rng.standard_normal(5) * 0.5).astype(np.float32)
    for fast in (False, True):
        np.testing.assert_allclose(
            t_snake.snake_beta(_t(x), _t(a), _t(b), fast).numpy(),
            _np(j_snake.snake_beta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), fast)), atol=ATOL)


def test_snake_modules_load_log_scale(rng):
    x = rng.standard_normal((2, 6, 4)).astype(np.float32)
    la, lb = (rng.standard_normal(4).astype(np.float32) * 0.3 for _ in range(2))
    sb = t_snake.SnakeBeta(4)
    sb.load_state_dict({"alpha": _t(la), "beta": _t(lb)})
    golden = j_snake.SnakeBeta().apply({"params": {"alpha": la, "beta": lb}}, jnp.asarray(x))
    np.testing.assert_allclose(sb(_t(x)).detach().numpy(), _np(golden), atol=ATOL)
    s = t_snake.Snake(4)
    s.load_state_dict({"alpha": _t(la)})
    golden = j_snake.Snake().apply({"params": {"alpha": la}}, jnp.asarray(x))
    np.testing.assert_allclose(s(_t(x)).detach().numpy(), _np(golden), atol=ATOL)


def test_kaiser_filter_and_resamplers(rng):
    np.testing.assert_array_equal(t_res.kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  j_res.kaiser_sinc_filter1d(0.25, 0.3, 12))
    assert t_res.kaiser_sinc_filter1d(0.25, 0.3, 12).dtype == np.float32
    x = rng.standard_normal((2, 40, 5)).astype(np.float32)
    np.testing.assert_allclose(t_res.upsample1d(_t(x)).numpy(), _np(j_res.upsample1d(jnp.asarray(x))),
                               atol=ATOL)
    np.testing.assert_allclose(t_res.downsample1d(_t(x)).numpy(),
                               _np(j_res.downsample1d(jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("form", ["conv", "fused"])
def test_alias_free_activation(rng, form):
    x = rng.standard_normal((2, 33, 5)).astype(np.float32)
    a = np.exp(rng.standard_normal(5) * 0.3).astype(np.float32)
    b = np.exp(rng.standard_normal(5) * 0.3).astype(np.float32)
    j_fn = j_res.alias_free_activation if form == "conv" else j_res.alias_free_activation_fused
    t_fn = t_res.alias_free_activation if form == "conv" else t_res.alias_free_activation_fused
    golden = j_fn(jnp.asarray(x), lambda h: j_snake.snake_beta(h, a, b))
    out = t_fn(_t(x), lambda h: t_snake.snake_beta(h, _t(a), _t(b)))
    np.testing.assert_allclose(out.numpy(), _np(golden), atol=ATOL)
    # the depthwise-conv channels-first form the wide vocoder stages run
    out_cf = t_res.alias_free_activation_cf(
        _t(x.transpose(0, 2, 1)), lambda h: t_snake.snake_beta(h, _t(a)[:, None], _t(b)[:, None]))
    np.testing.assert_allclose(out_cf.numpy().transpose(0, 2, 1), _np(golden), atol=ATOL)


@pytest.mark.parametrize("fast", [False, True])
def test_alias_free_snake_cf_and_conv1d_cf(rng, fast):
    x = rng.standard_normal((2, 6, 50)).astype(np.float32)
    a = np.exp(rng.standard_normal(6) * 0.3).astype(np.float32)
    b = np.exp(rng.standard_normal(6) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        t_rcf.alias_free_snake_cf(_t(x), _t(a), _t(b), fast).numpy(),
        _np(j_rcf.alias_free_snake_cf(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), fast)),
        atol=ATOL)
    w = rng.standard_normal((7, 6, 6)).astype(np.float32) * 0.3  # JAX (k, C_in, C_out)
    bias = rng.standard_normal(6).astype(np.float32)
    for d in (1, 3, 5):
        np.testing.assert_allclose(
            t_rcf.conv1d_cf(_t(x), _t(w.transpose(2, 1, 0)), _t(bias), d).numpy(),
            _np(j_rcf.conv1d_cf(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), d)), atol=ATOL)
