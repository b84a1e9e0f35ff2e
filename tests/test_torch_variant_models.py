"""Port parity: the variant denoisers (ConcatDiT, ConcatOrderDiT/2,
TxtFlagLargeDiT), the 2D KL and VQ VAEs and the trainable text encoder
against audiolcm_tpu.models, f32 on the CPU at tiny widths.

ConcatDiT takes one reference-layout state dict on both sides (the JAX
model through `convert_dit(..., dual_cond=False)`); the others draw every
parameter from a numpy seed (`random_params`: the flag DiT's zero-init
modulations, head and gates included, so no output is trivially 0) and
reach the port through `audiolcm_torch.convert`. atol 2e-5 (ROADMAP f32
bar); the host order helpers and the VQ indices are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.convert import (
    assign_state_dict,
    dit_from_jax,
    flag_dit_from_jax,
    text_transformer_from_jax,
    vae_from_jax,
)
from audiolcm_torch.models import dit as t_dit
from audiolcm_torch.models import flag_dit as t_flag
from audiolcm_torch.models import order_dit as t_order
from audiolcm_torch.models import text_transformer as t_text
from audiolcm_torch.models import vae2d as t_vae2d
from audiolcm_tpu.convert import convert_dit
from audiolcm_tpu.models import dit as j_dit
from audiolcm_tpu.models import flag_dit as j_flag
from audiolcm_tpu.models import order_dit as j_order
from audiolcm_tpu.models import text_transformer as j_text
from audiolcm_tpu.models import vae2d as j_vae2d
from audiolcm_tpu.models.vae1d import DiagonalGaussian as JGaussian
from tests.test_convert import _synthetic_dit_sd
from tests.test_torch_text import random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN = 4, 16, 32, 2, 4, 64
B, T, LC = 2, 10, 6
ATOL = 2e-5


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def _dit_inputs(seed: int, lc: int = LC):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, IN_CH)).astype(np.float32)
    ts = np.array([999, 321], dtype=np.int32)
    ctx = rng.standard_normal((B, lc, CTX)).astype(np.float32)
    w = rng.standard_normal((B, 256)).astype(np.float32)
    return x, ts, ctx, w


def _init_params(model, *args, seed: int, **kw):
    """Every leaf of model's parameter tree drawn from a numpy seed."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, **kw))["params"]
    return random_params(shapes, seed)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("with_w", [False, True])
def test_concat_dit_matches_jax(with_w):
    sd = {k.replace("c1_embedder", "c_embedder"): v * 0.05
          for k, v in _synthetic_dit_sd(IN_CH, CTX, HIDDEN, DEPTH, MAX_LEN).items()
          if not k.startswith("c2_embedder")}
    x, ts, ctx, w = _dit_inputs(1)
    w = w if with_w else None
    golden = j_dit.ConcatDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN).apply(
        {"params": convert_dit(sd, depth=DEPTH, dual_cond=False)},
        jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), None if w is None else jnp.asarray(w))
    port = t_dit.ConcatDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        out = port(*_torch(x, ts, ctx), None if w is None else torch.from_numpy(w))
    assert out.shape == (B, T, IN_CH)
    _close(out, golden)


def _caption_ids(seed: int, b: int = 3, l: int = 17):
    """Random ids with specials, '|' separators and padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 3000, (b, l))
    ids[:, 0] = 101
    for bi in range(b):
        end = rng.integers(max(4, l // 2), l)
        ids[bi, rng.choice(np.arange(2, end - 1), min(3, end - 3), replace=False)] = \
            t_order.SEP_ID
        ids[bi, end] = 102
        ids[bi, end + 1:] = 0
    orders = [list(rng.integers(0, 99, rng.integers(1, 6))) for _ in range(b)]
    return ids, orders


@pytest.mark.parametrize("seed", [0, 1])
def test_order_host_helpers_match_jax(seed):
    ids, orders = _caption_ids(seed)
    np.testing.assert_array_equal(t_order.compute_order_indices(ids, orders),
                                  j_order.compute_order_indices(ids, orders))
    for got, want in zip(t_order.compute_order_insertion(ids, orders, max_objs=6),
                         j_order.compute_order_insertion(ids, orders, max_objs=6)):
        np.testing.assert_array_equal(got, want)


def test_order_dit_matches_jax():
    ids, orders = _caption_ids(2, b=B, l=LC)
    order_index = t_order.compute_order_indices(ids, orders)
    order_index[0, 1] = -1
    x, ts, tok, w = _dit_inputs(3)
    jm = j_order.ConcatOrderDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN)
    args = [jnp.asarray(a) for a in (x, ts, tok, order_index, w)]
    params = _init_params(jm, *args, seed=4)
    golden = jm.apply({"params": params}, *args)
    port = assign_state_dict(t_order.ConcatOrderDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN),
                             dit_from_jax(params))
    with torch.no_grad():
        out = port(*_torch(x, ts, tok, order_index, w))
    assert (order_index < 0).any() and (order_index >= 0).any()
    _close(out, golden)


def test_order_dit2_matches_jax():
    max_objs = 4
    ids, orders = _caption_ids(5, b=B, l=LC)
    src, oid = t_order.compute_order_insertion(ids, orders, max_objs=max_objs)
    x, ts, tok, w = _dit_inputs(6)
    jm = j_order.ConcatOrderDiT2(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN)
    args = [jnp.asarray(a) for a in (x, ts, tok, src, oid, w)]
    params = _init_params(jm, *args, seed=7)
    golden = jm.apply({"params": params}, *args)
    port = assign_state_dict(t_order.ConcatOrderDiT2(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN),
                             dit_from_jax(params))
    with torch.no_grad():
        out = port(*_torch(x, ts, tok, src, oid, w))
    assert src.shape == (B, LC + max_objs) and (src < 0).any()
    _close(out, golden)


def test_rotary_matches_jax():
    cos, sin = t_flag.precompute_rotary(8, 20)
    jcos, jsin = j_flag.precompute_rotary(8, 20)
    np.testing.assert_array_equal(cos.numpy(), jcos)
    np.testing.assert_array_equal(sin.numpy(), jsin)
    x = np.random.default_rng(8).standard_normal((2, 20, 3, 8)).astype(np.float32)
    np.testing.assert_allclose(t_flag.apply_rotary(torch.from_numpy(x), cos, sin).numpy(),
                               np.asarray(j_flag.apply_rotary(jnp.asarray(x), jcos, jsin)),
                               atol=1e-6)


@pytest.mark.parametrize("knobs", [{}, {"n_kv_heads": 2}, {"qk_norm": True},
                                   {"n_kv_heads": 1, "qk_norm": True, "multiple_of": 48}])
def test_flag_dit_matches_jax(knobs):
    x, ts, ctx, _ = _dit_inputs(9)
    kw = dict(in_channels=IN_CH, context_dim=CTX, hidden_size=HIDDEN, depth=DEPTH,
              num_heads=HEADS, max_len=MAX_LEN, **knobs)
    jm = j_flag.TxtFlagLargeDiT(**kw)
    args = [jnp.asarray(a) for a in (x, ts, ctx)]
    params = _init_params(jm, *args, seed=10)
    golden = jm.apply({"params": params}, *args)
    port = assign_state_dict(t_flag.TxtFlagLargeDiT(**kw), flag_dit_from_jax(params))
    with torch.no_grad():
        out = port(*_torch(x, ts, ctx))
    assert float(np.abs(np.asarray(golden)).max()) > 0.1  # not the zero-init output
    _close(out, golden)


def test_flag_dit_is_zero_at_init():
    x, ts, ctx, _ = _dit_inputs(11)
    with torch.no_grad():
        out = t_flag.TxtFlagLargeDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN)(*_torch(x, ts, ctx))
    assert out.shape == (B, T, IN_CH) and not out.abs().any()


VAE2D = dict(in_channels=1, out_ch=1, ch=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=16, z_channels=4, embed_dim=4)


def _mel(seed: int, b: int = 2, h: int = 16, w: int = 12) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, 1, h, w)).astype(np.float32)


def _nhwc(a) -> np.ndarray:
    return np.transpose(np.asarray(a), (0, 2, 3, 1))


def test_vae2d_kl_matches_jax():
    """Moments, a posterior sample with injected noise, and its decode;
    the input is not square (H 16, W 12: W's downsample pads to 13)."""
    mel = _mel(12)
    jm = j_vae2d.AutoencoderKL2D(j_vae2d.VAE2DConfig(**VAE2D))
    key = jax.random.PRNGKey(0)
    params = random_params(jax.eval_shape(
        lambda: jm.init(key, jnp.asarray(_nhwc(mel)), key))["params"], 13)
    moments = jm.apply({"params": params}, jnp.asarray(_nhwc(mel)),
                       method=j_vae2d.AutoencoderKL2D.encode_moments)
    noise = np.random.default_rng(14).standard_normal(
        moments.shape[:-1] + (VAE2D["embed_dim"],)).astype(np.float32)
    post = JGaussian(moments)
    z = post.mean + post.std * jnp.asarray(noise)
    rec = jm.apply({"params": params}, z, method=j_vae2d.AutoencoderKL2D.decode)

    port = assign_state_dict(t_vae2d.AutoencoderKL2D(t_vae2d.VAE2DConfig(**VAE2D)),
                             vae_from_jax(params))
    with torch.no_grad():
        m = port.encode_moments(torch.from_numpy(mel))
        got, posterior = port(torch.from_numpy(mel),
                              noise=torch.from_numpy(np.transpose(noise, (0, 3, 1, 2))))
    assert m.shape == (2, 8, 8, 6)
    _close(m.permute(0, 2, 3, 1), moments)
    _close(posterior.logvar.permute(0, 2, 3, 1), post.logvar)
    _close(got.permute(0, 2, 3, 1), rec)
    assert got.shape == mel.shape


def test_vq2d_matches_jax():
    """Indices exactly equal; the quantized latent, the loss and the
    decode at atol 2e-5; the quantized latent has the straight-through
    gradient (1 for every element of z)."""
    cfg = dict(VAE2D, attn_resolutions=(), double_z=False)
    mel = _mel(15)
    jm = j_vae2d.VQModel2D(j_vae2d.VAE2DConfig(**cfg), n_embed=24)
    params = random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(_nhwc(mel))))["params"], 16)
    rec_j, loss_j, idx_j = jm.apply({"params": params}, jnp.asarray(_nhwc(mel)))
    quant_j, _, _ = jm.apply({"params": params}, jnp.asarray(_nhwc(mel)),
                             method=j_vae2d.VQModel2D.encode)
    port = assign_state_dict(t_vae2d.VQModel2D(t_vae2d.VAE2DConfig(**cfg), n_embed=24),
                             vae_from_jax(params))
    with torch.no_grad():
        rec, loss, idx = port(torch.from_numpy(mel))
        quant, _, _ = port.encode(torch.from_numpy(mel))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert len(np.unique(np.asarray(idx_j))) > 1
    _close(quant.permute(0, 2, 3, 1), quant_j)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    _close(rec.permute(0, 2, 3, 1), rec_j)
    z = torch.randn(1, 4, 3, 3, requires_grad=True)
    port.quantize(z)[0].sum().backward()
    assert torch.equal(z.grad, torch.ones_like(z))


def test_text_transformer_matches_jax():
    kw = dict(vocab_size=30, max_seq_len=16, dim=32, depth=2, num_heads=4, mlp_mult=4)
    ids = np.random.default_rng(17).integers(0, 30, (2, 11)).astype(np.int32)
    jm = j_text.TransformerTextEncoder(**kw)
    params = _init_params(jm, jnp.asarray(ids), seed=18)
    golden = jm.apply({"params": params}, jnp.asarray(ids))
    port = assign_state_dict(t_text.TransformerTextEncoder(**kw), text_transformer_from_jax(params))
    with torch.no_grad():
        out = port(torch.from_numpy(ids))
    assert out.shape == (2, 11, 32)
    _close(out, golden)
