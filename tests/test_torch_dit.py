"""Port parity: ConcatDiT2MLP against audiolcm_tpu.models.dit, f32 CPU.

One random reference-layout state dict feeds both sides: the JAX model
through `convert_dit`, the port directly. atol 2e-5 (ROADMAP f32 bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.models.dit import ConcatDiT2MLP as TorchDiT
from audiolcm_torch.nn.attention import fuse_qkv_state_dict
from audiolcm_tpu.convert import convert_dit
from audiolcm_tpu.models.dit import ConcatDiT2MLP as JaxDiT
from audiolcm_tpu.nn.attention import fuse_attention_params
from tests.test_convert import _synthetic_dit_sd
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN = 4, 16, 32, 2, 4, 64


def _inputs(rng, b=2, t=10, lc=3):
    x = rng.standard_normal((b, t, IN_CH)).astype(np.float32)
    ts = np.array([999, 499][:b], dtype=np.int32)
    ctx = rng.standard_normal((b, 2 * lc, CTX)).astype(np.float32)
    w = rng.standard_normal((b, 256)).astype(np.float32)
    return x, ts, ctx, w


@pytest.fixture(scope="module")
def dit_sd():
    return {k: v * 0.05 for k, v in _synthetic_dit_sd(IN_CH, CTX, HIDDEN, DEPTH, MAX_LEN).items()}


def _torch_dit(sd, **kw):
    mod = TorchDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN, **kw)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    mod.load_state_dict(fuse_qkv_state_dict(sd) if kw.get("fuse_qkv") else sd)
    return mod.eval()


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_dit_matches_jax(rng, dit_sd, fuse_qkv, use_flash):
    """use_flash=True on both sides: the JAX Pallas kernel in interpret
    mode, the port's flash path (its plain version on the CPU)."""
    x, ts, ctx, w = _inputs(rng)
    jparams = convert_dit(dit_sd, depth=DEPTH)
    if fuse_qkv:
        jparams = fuse_attention_params(jparams)
    golden = JaxDiT(IN_CH, CTX, HIDDEN, DEPTH, HEADS, MAX_LEN, use_flash=use_flash,
                    fuse_qkv=fuse_qkv).apply(
        {"params": jparams}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(w))
    mod = _torch_dit(dit_sd, fuse_qkv=fuse_qkv, use_flash=use_flash)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                  torch.from_numpy(w))
    assert out.shape == (2, 10, IN_CH)
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


def test_dit_bf16_stream_stays_bf16(rng, dit_sd):
    """The f32 timestep token and condition tokens are cast to the stream
    dtype, so a bf16 model on bf16 latents returns bf16."""
    x, ts, ctx, w = _inputs(rng)
    mod = _torch_dit(dit_sd).to(torch.bfloat16)
    with torch.no_grad():
        out = mod(torch.from_numpy(x).bfloat16(), torch.from_numpy(ts),
                  torch.from_numpy(ctx).bfloat16(), torch.from_numpy(w).bfloat16())
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()

