"""Flash self-attention (K3): the plain version and the kernel's blockwise
algorithm against audiolcm_tpu.nn.pallas_attention.flash_attention, and the
CUDA kernel against the plain version on the card (`gpu` marker).

The JAX kernel runs in interpret mode. Inputs come from a numpy seed; f32
tolerance atol 2e-5, the bar of tests/test_pallas_attention.py:26.
"""

import numpy as np
import pytest
import torch

from audiolcm_torch.nn import flash_attention as F
from audiolcm_torch.nn.attention import dot_product_attention

try:
    import jax.numpy as jnp

    from audiolcm_tpu.nn.pallas_attention import flash_attention as jax_flash
except ImportError:  # the gpu test needs no JAX
    jnp = jax_flash = None

ATOL = 2e-5


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_golden(q, k, v, scale):
    return np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                interpret=True))


@pytest.mark.parametrize("shape", [(1, 2, 128, 72), (1, 2, 300, 72), (1, 2, 467, 72),
                                   (1, 1, 100, 8)])
def test_plain_and_blocked_match_jax_flash(shape):
    """t = 128, 300, 467 at the DiT's d = 72, and the padding case of
    test_pallas_attention.py:28-37 (T = 100 in a padded block)."""
    q, k, v = _qkv(shape[2], shape)
    scale = shape[-1] ** -0.5
    golden = _jax_golden(q, k, v, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(F.flash_attention_plain(tq, tk, tv, scale).numpy(), golden,
                               atol=ATOL)
    np.testing.assert_allclose(F.flash_attention_blocked(tq, tk, tv, scale).numpy(), golden,
                               atol=ATOL)


@pytest.mark.parametrize("block_k,chunk", [(64, 16), (32, 8), (16, 16)])
def test_blocked_tiles_and_chunks_ragged(block_k, chunk):
    """The kernel's decomposition is independent of its tile and chunk
    sizes, including a tail tile with a partly masked chunk and chunks
    wholly past T (T = 467 = 7*64 + 19)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (2, 3, 467, 72)))
    plain = F.flash_attention_plain(q, k, v, 0.2)
    out = F.flash_attention_blocked(q, k, v, 0.2, block_k=block_k, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL)


def test_bf16_blocked_error_not_worse_than_plain():
    """chip_smoke's bf16 bar: against the f32 result, the kernel's algorithm
    on bf16 inputs has a mean error at most 1.02x the plain version's (both
    widen to f32 and round once at the output)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, (1, 2, 300, 72)))
    ref = F.flash_attention_plain(q, k, v, 72 ** -0.5)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    blocked = F.flash_attention_blocked(qb, kb, vb, 72 ** -0.5)
    plain = F.flash_attention_plain(qb, kb, vb, 72 ** -0.5)
    assert blocked.dtype == plain.dtype == torch.bfloat16
    err = lambda y: (y.float() - ref).abs().mean().item()
    assert err(blocked) <= 1.02 * err(plain)


def test_wrapper_dispatch_views_and_validation():
    """CPU tensors run the plain version and launch nothing; the chunk views
    of a fused qkv projection are taken as they are; bad inputs raise."""
    b, t, h, d = 2, 37, 3, 8
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, t, 3 * h * d)).astype(np.float32))
    q, k, v = (a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    F.LAUNCHES = 0
    out = F.flash_attention(q, k, v, d ** -0.5)
    assert F.LAUNCHES == 0
    np.testing.assert_allclose(out.numpy(), F.flash_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), d ** -0.5).numpy(), atol=ATOL)
    np.testing.assert_allclose(F.attention_auto(q, k, v, d ** -0.5).numpy(),
                               dot_product_attention(q, k, v, d ** -0.5).numpy())
    with pytest.raises(ValueError, match="one \\(B, H, T, D\\) shape"):
        F.flash_attention(q, k[:, :, :-1], v, 0.1)
    with pytest.raises(TypeError, match="one dtype"):
        F.flash_attention(q, k.double(), v, 0.1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        F.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), 0.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m gpu "
                    "tests/test_torch_flash_attention.py)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 8, 467, 72), (2, 8, 1000, 72), (1, 2, 100, 8),
                                   (2, 3, 5, 33)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    """The sm_90a kernel against the plain version on the card: f32 (matmul
    TF32 off) at atol 2e-5, and in bf16 against the f32 plain result no
    worse than the plain bf16 path x1.02; one launch per call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(6, shape))
    scale = shape[-1] ** -0.5
    plain = F.flash_attention_plain(q, k, v, scale)
    before = F.LAUNCHES
    out = F.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert F.LAUNCHES == before + 1
    assert (out - plain).abs().max().item() <= ATOL
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kern = F.flash_attention(qb, kb, vb, scale).float()
    pb = F.flash_attention_plain(qb, kb, vb, scale).float()
    assert (kern - plain).abs().mean() <= (pb - plain).abs().mean() * 1.02
