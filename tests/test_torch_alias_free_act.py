"""The vocoder's alias-free activation K5 (`nn/alias_free_act.py`,
`csrc/alias_free_act.cu`) against the JAX package's
`audiolcm_tpu.nn.resample.alias_free_activation` (the depthwise-conv form)
and against `models/bigvgan.py:Activation1d`'s depthwise-conv form.

On the CPU: the kernel's tiling in torch (`alias_free_act_tiles_emulated`)
and the wrapper's plain version, f32 at atol 2e-5 (the port's module bar),
edges included, at tiles that divide T, ragged tiles, T shorter than one
tile and T <= 13; SnakeBeta and Snake, log-scale and linear, the exact and
the polynomial cos. Then the wrapper's checks and `Activation1d`'s
dispatch, which on the CPU and under autograd stays bit for bit what it
was. Inputs come from numpy seeds.

On the card (`-m gpu`): the kernel against the plain version at the
served shapes, and its launch counter in eager calls and graph replays.
"""

import os
import re

import numpy as np
import pytest
import torch

from audiolcm_torch import obs
from audiolcm_torch.models.bigvgan import CF_STAGE_MAX_CHANNELS, Activation1d
from audiolcm_torch.nn import alias_free_act as K
from audiolcm_torch.nn.resample import alias_free_activation_cf, alias_free_taps
from audiolcm_torch.nn.resample_cf import alias_free_snake_cf
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

try:
    import jax
    import jax.numpy as jnp

    from audiolcm_tpu.nn.resample import alias_free_activation as jax_alias_free_activation
    from audiolcm_tpu.nn.snake import snake_beta as jax_snake_beta
except ImportError:  # the machine with the card has no JAX: only the gpu tests run there
    jax = jnp = jax_alias_free_activation = jax_snake_beta = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = [("snakebeta", True), ("snakebeta", False), ("snake", True), ("snake", False)]


def _x(seed, b, c, t):
    return np.random.default_rng(seed).standard_normal((b, c, t)).astype(np.float32)


def _module(c, kind, logscale, fast, seed, dtype=torch.float32):
    """Activation1d with random parameters: log-scale ~0.3 N, linear exp of it."""
    act = Activation1d(c, kind, logscale, fast)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in act.act.parameters():
            raw = 0.3 * rng.standard_normal(c)
            p.copy_(torch.from_numpy(raw if logscale else np.exp(raw)))
    return act.to(dtype)


def _params(act):
    """(alpha, beta) as the module holds them, as K5 reads them: Snake's
    alpha twice."""
    return act.act.alpha, getattr(act.act, "beta", act.act.alpha)


def jax_golden(x, act):
    """JAX's depthwise-conv Activation1d on (B, C, T) x with the module's
    linear-scale parameters: (B, C, T)."""
    a, b = (v.detach().numpy() for v in act.act.linear_params())
    fn = lambda h: jax_snake_beta(h, jnp.asarray(a), jnp.asarray(b), fast=act.act.fast)
    out = jax.jit(lambda v: jax_alias_free_activation(v, fn))(jnp.asarray(x.transpose(0, 2, 1)))
    return np.asarray(out).transpose(0, 2, 1)


@pytest.mark.parametrize("kind,logscale", KINDS)
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("t,tile", [(100, 32), (500, None), (13, None), (5, 16)])
def test_emulation_and_plain_match_jax_and_depthwise_f32(kind, logscale, fast, t, tile):
    """A ragged multi-tile row, a row shorter than the kernel's one tile, and
    rows of T <= 13 (every output within the halo of both edges)."""
    act = _module(4, kind, logscale, fast, seed=t)
    x = _x(t, 2, 4, t)
    golden = jax_golden(x, act)
    xt = torch.from_numpy(x)
    alpha, beta = _params(act)
    with torch.no_grad():
        depthwise = alias_free_activation_cf(xt, act.act).numpy()
        emulated = K.alias_free_act_tiles_emulated(xt, alpha, beta, logscale, fast, tile).numpy()
        plain = K.alias_free_act(xt, alpha, beta, logscale, fast).numpy()
    assert emulated.shape == plain.shape == golden.shape == (2, 4, t)
    for got in (emulated, plain):
        for want in (golden, depthwise):
            np.testing.assert_allclose(got, want, atol=2e-5)
            np.testing.assert_allclose(got[..., :6], want[..., :6], atol=2e-5)
            np.testing.assert_allclose(got[..., -6:], want[..., -6:], atol=2e-5)


@pytest.mark.parametrize("t", [2496, 9984 + 40])
def test_emulation_at_kernel_tile_matches_plain_f32(t):
    """The kernel's own tile (`pick_tile`): one full tile (the b8 C=768
    stage's T), and several with a ragged last one."""
    act = _module(3, "snakebeta", True, True, seed=3)
    xt = torch.from_numpy(_x(t, 1, 3, t))
    alpha, beta = _params(act)
    with torch.no_grad():
        plain = K.alias_free_act_plain(xt, alpha, beta, True, True)
        emulated = K.alias_free_act_tiles_emulated(xt, alpha, beta, True, True)
    np.testing.assert_allclose(emulated.numpy(), plain.numpy(), atol=2e-5)


def test_emulation_rounds_once_in_bf16():
    """bf16 in and out, f32 inside: nearer the f32 result than the plain
    bf16 chain, which rounds at every op."""
    act = _module(4, "snakebeta", True, True, seed=5)
    x = torch.from_numpy(_x(5, 2, 4, 300)).bfloat16()
    alpha, beta = _params(act)
    with torch.no_grad():
        want = K.alias_free_act_plain(x.float(), alpha, beta, True, True)
        em = K.alias_free_act_tiles_emulated(x, alpha.bfloat16(), beta.bfloat16(), True, True)
        pb = K.alias_free_act_plain(x, alpha.bfloat16(), beta.bfloat16(), True, True)
    assert em.dtype == torch.bfloat16
    assert (em.float() - want).abs().mean() < (pb.float() - want).abs().mean()


@pytest.mark.parametrize("t", [1, 13, 16, 17, 1248, 2496, 4992, 9984, 19968, 39936, 79872,
                               159744, 319488])
def test_tile_fits_a_block_and_launches_few_idle_lanes(t):
    """Every served row length (the b8 and b1 vocoder stages) and short ones:
    the tile is a multiple of RUN, its lanes fit MAX_WARPS warps, the tiles
    cover T, and from T >= 2496 at most 3 % of the launched lanes hold no
    sample of the row."""
    tile = K.pick_tile(t)
    n_tiles, lanes = -(-t // tile), tile // K.RUN + 2
    warps = -(-lanes // 32)
    assert tile % K.RUN == 0 and warps <= K.MAX_WARPS and (n_tiles - 1) * tile < t
    if t >= 2496:
        assert t / K.RUN >= 0.97 * n_tiles * 32 * warps


def test_kernel_source_constants_match_python():
    """The taps the kernel holds as literals are alias_free_taps() in
    float32, bit for bit, and RUN / MAX_WARPS agree with the wrapper."""
    src = open(os.path.join(ROOT, "audiolcm_torch", "csrc", "alias_free_act.cu")).read()
    for name, taps in zip(("UP_E", "UP_O", "DN_E", "DN_O"), alias_free_taps()):
        body = re.search(rf"float {name}\(int d\) \{{(.*?)\}}", src, re.S).group(1)
        lits = [float(np.float32(v)) for v in re.findall(r"(-?\d\.\d+e[-+]\d+)f", body)]
        assert lits == [float(np.float32(v)) for v in taps], name
    assert int(re.search(r"#define RUN (\d+)", src).group(1)) == K.RUN
    assert int(re.search(r"#define MAX_WARPS (\d+)", src).group(1)) == K.MAX_WARPS


def test_wrapper_validation_and_cpu_path():
    act = _module(6, "snakebeta", True, True, seed=7)
    x = torch.from_numpy(_x(7, 2, 6, 100))
    a, b = _params(act)
    a, b = a.detach(), b.detach()
    before = obs.counters()
    assert torch.equal(K.alias_free_act(x, a, b, True, True),
                       K.alias_free_act_plain(x, a, b, True, True))
    assert obs.counters() == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match=r"\(B, C, T\)"):
        K.alias_free_act(x[0], a, b, True, True)
    with pytest.raises(ValueError, match="alpha and beta"):
        K.alias_free_act(x, a[:5], b, True, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.alias_free_act(x.double(), a, b, True, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.alias_free_act(x, a.half(), b.half(), True, True)
    with pytest.raises(TypeError, match="differ in dtype"):
        K.alias_free_act(x, a, b.bfloat16(), True, True)
    with pytest.raises(ValueError, match="contiguous"):
        K.alias_free_act(x.transpose(1, 2).contiguous().transpose(1, 2), a, b, True, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.alias_free_act(x.to("meta"), a.to("meta"), b.to("meta"), True, True)
    with pytest.raises(ValueError, match="T >= 1"):
        K.pick_tile(0)


@pytest.mark.parametrize("kind,logscale", KINDS)
@pytest.mark.parametrize("polyphase", [False, True])
def test_activation1d_on_the_cpu_and_under_autograd_is_unchanged(kind, logscale, polyphase):
    """On the CPU, with and without autograd, Activation1d runs the two torch
    forms it always ran, bit for bit, and launches nothing: the polyphase
    form up to CF_STAGE_MAX_CHANNELS, the depthwise conv above it."""
    c = 5 if polyphase else CF_STAGE_MAX_CHANNELS + 8
    act = _module(c, kind, logscale, True, seed=11)
    assert act.polyphase == polyphase
    x = torch.from_numpy(_x(11, 2, c, 77))
    a, b = act.act.linear_params()
    before = obs.counters()
    got = act(x)
    assert got.requires_grad  # autograd recorded it: the trainer's path
    with torch.no_grad():
        was = (alias_free_snake_cf(x, a, b, fast=True) if polyphase
               else alias_free_activation_cf(x, act.act))
        assert torch.equal(got.detach(), was) and torch.equal(act(x), was)
    with torch.inference_mode():
        assert torch.equal(act(x), was)
    assert obs.counters() == before


# ----------------------------------------------------------------- on the card

# the served rows: the b8 10 s generate's unfused stages and activation_post
# (batch 8, mel 624), and the b1 20 s class's (batch 1, mel 1248)
SERVED = [(8, 768, 2496), (8, 384, 9984), (8, 192, 19968), (8, 96, 39936), (8, 24, 159744),
          (1, 768, 4992), (1, 384, 19968), (1, 192, 39936), (1, 96, 79872), (1, 24, 319488)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device "
                    "(run: python -m pytest -m gpu tests/test_torch_alias_free_act.py)")
    return torch.device("cuda:0")


def _card_module(c, kind, logscale, fast, device, dtype):
    """The vocoder's init: log-scale parameters ~0.1 N (linear: exp of it)."""
    act = Activation1d(c, kind, logscale, fast)
    g = torch.Generator().manual_seed(c)
    with torch.no_grad():
        for p in act.act.parameters():
            raw = 0.1 * torch.randn(c, generator=g)
            p.copy_(raw if logscale else raw.exp())
    return act.to(device=device, dtype=dtype)


def _launches():
    return obs.counters().get("alias_free_act", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,t", SERVED)
def test_kernel_matches_plain_at_served_shapes_on_card(cuda_device, b, c, t):
    """bf16, fast cos, SnakeBeta in log scale, as served: the kernel's mean
    error against the f32 plain version (same bf16 input and parameters) at
    most 1.02x the depthwise bf16 form's; and the same call in f32 within
    1e-5 of the f32 plain version everywhere. One launch per call."""
    act = _card_module(c, "snakebeta", True, True, cuda_device, torch.bfloat16)
    x = torch.randn(b, c, t, generator=torch.Generator(cuda_device).manual_seed(t),
                    device=cuda_device).bfloat16()
    alpha, beta = act.act.alpha, act.act.beta
    with torch.inference_mode():
        want = K.alias_free_act_plain(x.float(), alpha.float(), beta.float(), True, True)
        n0 = _launches()
        kb = act(x).float()
        torch.cuda.synchronize()
        assert _launches() == n0 + 1
        dw = alias_free_activation_cf(x, act.act).float()
        assert (kb - want).abs().mean() <= 1.02 * (dw - want).abs().mean()
        kf = K.alias_free_act(x.float(), alpha.float(), beta.float(), True, True)
        assert (kf - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kind,logscale", KINDS)
@pytest.mark.parametrize("fast", [False, True])
def test_kernel_matches_plain_in_f32_on_card(cuda_device, kind, logscale, fast):
    """f32, every parameter form and both cos forms, at row lengths that take
    the element loads (odd T, T <= 13), a ragged last tile, and 16-byte
    rows: max abs error <= 1e-5, the first and last 6 samples included."""
    for b, c, t in [(2, 5, 1), (2, 5, 13), (2, 5, 1001), (3, 7, 4096 + 8), (1, 3, 20000)]:
        act = _card_module(c, kind, logscale, fast, cuda_device, torch.float32)
        x = 2 * torch.randn(b, c, t, generator=torch.Generator(cuda_device).manual_seed(t),
                            device=cuda_device)
        alpha = act.act.alpha.detach()
        beta = alpha if kind == "snake" else act.act.beta.detach()
        want = K.alias_free_act_plain(x, alpha, beta, logscale, fast)
        got = K.alias_free_act(x, alpha, beta, logscale, fast)
        err = (got - want).abs()
        assert err.max().item() <= 1e-5, (b, c, t)
        assert max(err[..., :6].max().item(), err[..., -6:].max().item()) <= 1e-5


@pytest.mark.gpu
def test_counter_steps_once_per_launch_and_per_replay_on_card(cuda_device):
    act = _card_module(96, "snakebeta", True, True, cuda_device, torch.bfloat16)
    x = torch.randn(2, 96, 4000, device=cuda_device).bfloat16()
    with torch.inference_mode():
        n0 = _launches()
        eager = act(x)
        assert _launches() == n0 + 1
        graph = torch.cuda.CUDAGraph()
        act(x)  # warm on the side stream the capture uses
        with obs.capture(cuda_device) as tally, torch.cuda.graph(graph):
            out = act(x)
        assert tally.counts == {"alias_free_act": 1}
        n1 = _launches()
        for _ in range(3):
            with obs.launch(tally):
                graph.replay()
        torch.cuda.synchronize()
        assert _launches() == n1 + 3
        assert torch.equal(out, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("polyphase", [False, True])
def test_activation1d_under_autograd_on_card_keeps_the_torch_forms(cuda_device, polyphase):
    """Under autograd (the vocoder-GAN trainer) the card runs the torch
    forms, bit for bit, launches nothing and passes gradients back; without
    autograd the same call is one launch of K5."""
    c = CF_STAGE_MAX_CHANNELS if polyphase else 96
    act = _card_module(c, "snakebeta", True, True, cuda_device, torch.float32)
    x = torch.randn(2, c, 1000, device=cuda_device, requires_grad=True)
    a, b = act.act.linear_params()
    n0 = _launches()
    got = act(x)
    was = (alias_free_snake_cf(x, a, b, fast=True) if polyphase
           else alias_free_activation_cf(x, act.act))
    assert _launches() == n0 and torch.equal(got, was)
    got.sum().backward()
    assert x.grad is not None and act.act.alpha.grad is not None
    with torch.no_grad():
        act(x)
    assert _launches() == n0 + 1
