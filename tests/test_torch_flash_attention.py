"""Flash attention (K3): the plain version and the tensor-core kernel's
blockwise algorithm against audiolcm_tpu.nn.pallas_attention.flash_attention,
the wrapper's route choice, and the CUDA kernels against the plain version
on the card (`gpu` marker).

The JAX kernel runs in interpret mode. Inputs come from a numpy seed; f32
tolerance atol 2e-5, the bar of tests/test_pallas_attention.py:26; bf16:
mean error against the f32 result at most 1.02x the plain bf16 path's.
"""

import numpy as np
import pytest
import torch

from audiolcm_torch import obs
from audiolcm_torch.nn import flash_attention as F
from audiolcm_torch.nn.attention import dot_product_attention
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

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
                                   (1, 1, 100, 8), (1, 1, 1000, 72), (1, 1, 300, 64),
                                   (1, 1, 200, 128)])
def test_plain_and_blocked_match_jax_flash(shape):
    """t = 128, 300, 467 and the longest DiT sequence (1000) at the DiT's
    d = 72, the padding case of test_pallas_attention.py:28-37 (T = 100 in
    a padded block), and the widest heads the kernel takes (d = 64, 128);
    the blocked form in f32 (scale on the f32 logits)."""
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
    """The kernel's decomposition is independent of its tile size and of
    the keys per softmax step (the tensor-core kernel: one step per 64-key
    tile; the f32 CUDA-core kernel: 16-key chunks), including a ragged tail
    tile and steps wholly past T (T = 467 = 7*64 + 19)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (2, 3, 467, 72)))
    plain = F.flash_attention_plain(q, k, v, 0.2)
    out = F.flash_attention_blocked(q, k, v, 0.2, block_k=block_k, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL)


def test_bf16_blocked_error_not_worse_than_plain():
    """chip_smoke's bf16 bar: against the f32 result, the kernel's algorithm
    on bf16 inputs (bf16 products, f32 sums, P split into bf16 hi + lo) has a
    mean error at most 1.02x the plain version's (which widens to f32 and
    rounds once at the output)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, (1, 2, 300, 72)))
    ref = F.flash_attention_plain(q, k, v, 72 ** -0.5)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    blocked = F.flash_attention_blocked(qb, kb, vb, 72 ** -0.5)
    plain = F.flash_attention_plain(qb, kb, vb, 72 ** -0.5)
    assert blocked.dtype == plain.dtype == torch.bfloat16
    err = lambda y: (y.float() - ref).abs().mean().item()
    assert err(blocked) <= 1.02 * err(plain)


def _bf16_errors(shape, seed):
    """Mean errors against the f32 plain result of the bf16 plain path, the
    kernel's algorithm with P split, and with one bf16 P."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed, shape))
    scale = shape[-1] ** -0.5
    ref = F.flash_attention_plain(q, k, v, scale)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    err = lambda y: (y.float() - ref).abs().mean().item()
    return (err(F.flash_attention_plain(qb, kb, vb, scale)),
            err(F.flash_attention_blocked(qb, kb, vb, scale)),
            err(F.flash_attention_blocked(qb, kb, vb, scale, split_p=False)))


@pytest.mark.parametrize("shape", [(1, 2, 467, 72), (1, 2, 1000, 72)])
def test_bf16_split_p_meets_bar(shape):
    """At the DiT's sequence (467) and the longest one (1000), the split-P
    algorithm meets the 1.02x bar."""
    plain, split, _ = _bf16_errors(shape, seed=shape[2])
    assert split <= 1.02 * plain


def test_bf16_single_p_misses_bar():
    """Why the kernel splits P: one bf16 P adds a rounding about the size of
    the inputs' (mean error ~1.09x the plain path's here) and misses the
    bar that the split meets on the same inputs."""
    plain, split, single = _bf16_errors((1, 2, 467, 72), seed=467)
    assert single > split
    assert single > 1.02 * plain


def test_route_choice():
    """pick_route is a pure function of dtype, shape, strides and alignment:
    chunk views of a fused qkv projection and the DiT's head splits take the
    16-byte route; D = 33, an odd t-stride or a base off 16 bytes the
    element-wise one; f32 the CUDA-core kernel."""
    b, t, h, d = 2, 37, 3, 72
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.bfloat16)
    views = [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.chunk(3, dim=-1)]
    assert F.pick_route(*views) == "tc_vec"
    split = torch.zeros(b, t, h, d, dtype=torch.bfloat16).transpose(1, 2)
    assert F.pick_route(split, split, split) == "tc_vec"
    assert F.pick_route(*(a.float() for a in views)) == "cuda_core"
    odd = torch.zeros(2, 3, 5, 33, dtype=torch.bfloat16)
    assert F.pick_route(odd, odd, odd) == "tc_elementwise"
    off = torch.zeros(2, 3, 5, 80, dtype=torch.bfloat16)[..., 1:73]
    assert F.pick_route(views[0], off, views[2]) == "tc_elementwise"
    t_odd = torch.zeros(2, 3, 5, 76, dtype=torch.bfloat16)[..., :72]
    assert F.pick_route(t_odd, t_odd, t_odd) == "tc_elementwise"
    one = torch.zeros(1, 1, 1, 72, dtype=torch.bfloat16)
    assert F.pick_route(one, one, one) == "tc_vec"


def test_wrapper_dispatch_views_and_validation():
    """CPU tensors run the plain version and launch nothing; the chunk views
    of a fused qkv projection are taken as they are; bad inputs raise."""
    b, t, h, d = 2, 37, 3, 8
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b, t, 3 * h * d)).astype(np.float32))
    q, k, v = (a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    before = obs.counters()
    out = F.flash_attention(q, k, v, d ** -0.5)
    F.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), d ** -0.5)
    assert obs.counters() == before
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


@pytest.mark.parametrize("split_p", [True, False], ids=["split-p", "single-p"])
@pytest.mark.parametrize("tq,tk", [(312, 154), (70, 130)], ids=["flag-cross", "ragged"])
def test_blocked_matches_plain_with_its_own_key_length(tq, tk, split_p):
    """Keys of another length than the queries (the Flag DiT's caption
    branch: 312 latent queries against 154 caption keys, and a ragged 70
    against 130, whose last 64-key tile holds 2 keys): the kernel's
    algorithm equals the plain version in f32 at atol 2e-5, and in bf16
    with P split meets the 1.02x bar (one bf16 P stays within 1.25x)."""
    shape = (2, 3, tq, 72)
    q = torch.from_numpy(_qkv(tq, shape)[0])
    k, v = (torch.from_numpy(a) for a in _qkv(tk, (2, 3, tk, 72))[:2])
    scale = 72 ** -0.5
    ref = F.flash_attention_plain(q, k, v, scale)
    assert ref.shape == shape
    out = F.flash_attention_blocked(q, k, v, scale, split_p=split_p)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    err = lambda y: (y.float() - ref).abs().mean().item()
    blocked = F.flash_attention_blocked(qb, kb, vb, scale, split_p=split_p)
    assert blocked.dtype == torch.bfloat16 and blocked.shape == shape
    assert err(blocked) <= (1.02 if split_p else 1.25) * err(
        F.flash_attention_plain(qb, kb, vb, scale))


def test_wrapper_takes_its_own_key_length():
    """On the CPU a call with Tk != T runs the plain version and counts no
    launch; k and v must agree with each other and with q's B, H and D."""
    q = torch.from_numpy(_qkv(8, (2, 3, 11, 8))[0])
    k, v = (torch.from_numpy(a) for a in _qkv(9, (2, 3, 5, 8))[:2])
    before = obs.counters()
    out = F.flash_attention(q, k, v, 0.3)
    assert obs.counters() == before
    np.testing.assert_allclose(out.numpy(), F.flash_attention_plain(q, k, v, 0.3).numpy())
    for bad in ((k, v[:, :, :-1]), (k[:, :2], v[:, :2]), (k[..., :4], v[..., :4])):
        with pytest.raises(ValueError, match="\\(B, H, Tk, D\\)"):
            F.flash_attention(q, *bad, 0.3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m gpu "
                    "tests/test_torch_flash_attention.py)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 8, 467, 72), (2, 8, 1000, 72), (1, 2, 100, 8),
                                   (2, 3, 5, 33), (2, 4, 300, 64), (2, 2, 200, 128)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    """The sm_90a kernels against the plain version on the card: f32 on the
    CUDA-core kernel (matmul TF32 off) at atol 2e-5, and bf16 on the
    tensor-core kernel (16-byte loads, or element-wise at D = 33) against
    the f32 plain result no worse than the plain bf16 path x1.02; one launch
    per call, counted in the recorder's `flash_attention.f32` for f32 and
    `flash_attention.tc` for bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(6, shape))
    scale = shape[-1] ** -0.5
    plain = F.flash_attention_plain(q, k, v, scale)
    launches = lambda: (obs.counters().get("flash_attention.f32", 0),
                        obs.counters().get("flash_attention.tc", 0))
    before, before_tc = launches()
    out = F.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert launches() == (before + 1, before_tc)
    assert (out - plain).abs().max().item() <= ATOL
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    assert F.pick_route(qb, kb, vb) == ("tc_vec" if shape[-1] % 8 == 0 else "tc_elementwise")
    kern = F.flash_attention(qb, kb, vb, scale).float()
    torch.cuda.synchronize()
    assert launches() == (before + 1, before_tc + 1)
    pb = F.flash_attention_plain(qb, kb, vb, scale).float()
    assert (kern - plain).abs().mean() <= (pb - plain).abs().mean() * 1.02


@pytest.mark.gpu
def test_kernel_qkv_views_on_card(cuda_device):
    """bf16 chunk views of one to_qkv output at the teacher's shape take the
    16-byte route and meet the bf16 bar; the output's (B, T, H, D) storage
    is what the output projection reads."""
    b, t, h, d = 16, 467, 8, 72
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * d)).astype(np.float32))
    q, k, v = (a.reshape(b, t, h, d).transpose(1, 2).to(cuda_device)
               for a in qkv.chunk(3, dim=-1))
    plain = F.flash_attention_plain(q, k, v, d ** -0.5)
    qb, kb, vb = (a.reshape(b, t, h, d).transpose(1, 2) for a in
                  qkv.to(cuda_device).bfloat16().chunk(3, dim=-1))
    assert F.pick_route(qb, kb, vb) == "tc_vec"
    out = F.flash_attention(qb, kb, vb, d ** -0.5)
    torch.cuda.synchronize()
    assert out.transpose(1, 2).is_contiguous()
    pb = F.flash_attention_plain(qb, kb, vb, d ** -0.5).float()
    assert (out.float() - plain).abs().mean() <= (pb - plain).abs().mean() * 1.02



@pytest.mark.gpu
@pytest.mark.parametrize("shape,tk", [((16, 32, 312, 72), 154), ((2, 3, 70, 72), 130),
                                      ((2, 3, 40, 33), 100)],
                         ids=["flag-cross", "ragged", "elementwise"])
def test_kernel_matches_plain_with_its_own_key_length_on_card(cuda_device, shape, tk):
    """Cross-attention on the card, at the Flag DiT's caption branch
    (16, 32, 312 -> 154, 72), a ragged 70 -> 130 and D = 33 on the
    element-wise loads, at the bars of the self-attention test: f32 on the
    CUDA-core kernel at atol 2e-5, bf16 on the tensor-core kernel no worse
    than the plain bf16 path x1.02."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.from_numpy(_qkv(10, shape)[0]).to(cuda_device)
    k, v = (torch.from_numpy(a).to(cuda_device)
            for a in _qkv(11, shape[:2] + (tk, shape[-1]))[:2])
    scale = shape[-1] ** -0.5
    plain = F.flash_attention_plain(q, k, v, scale)
    out = F.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert (out - plain).abs().max().item() <= ATOL
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kern = F.flash_attention(qb, kb, vb, scale).float()
    torch.cuda.synchronize()
    pb = F.flash_attention_plain(qb, kb, vb, scale).float()
    assert (kern - plain).abs().mean() <= (pb - plain).abs().mean() * 1.02


@pytest.mark.gpu
def test_cross_counter_counts_cross_launches_only_on_card(cuda_device):
    """`flash_attention.cross` counts one per launch whose keys number other
    than its queries and none per self-attention launch, while
    `flash_attention.tc` counts both."""
    b, h, t, d = 16, 32, 312, 72
    q, k, v = (torch.randn(b, h, t, d, device=cuda_device, dtype=torch.bfloat16)
               for _ in range(3))
    yk, yv = (torch.randn(b, h, 154, d, device=cuda_device, dtype=torch.bfloat16)
              for _ in range(2))
    read = lambda: (obs.counters().get(F.CROSS_COUNTER, 0),
                    obs.counters().get("flash_attention.tc", 0))
    cross, tc = read()
    F.flash_attention(q, k, v, d ** -0.5)
    assert read() == (cross, tc + 1)
    F.flash_attention(q, yk, yv, d ** -0.5)
    F.flash_attention(q, yk, yv, d ** -0.5)
    torch.cuda.synchronize()
    assert read() == (cross + 2, tc + 3)
