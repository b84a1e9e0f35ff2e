"""The vocoder's wide resblock conv K6 (`nn/wide_conv.py`, `csrc/wide_conv.cu`)
and its dispatch from `models/bigvgan.py`.

On the CPU: the kernel's tile walk in torch (`wide_conv_tiles_emulated`:
16-byte aligned windows shifted per tap, zero fill outside the clip and
beyond C, f32 sums, the epilogue's bias, residual, running resblock sum and
1 / nk) against `F.conv1d` with the sums `AMPBlock1` / `BigVGAN.forward`
take without K6, in f32 to 1e-5, at the four wide widths x kernels
(3, 7, 11) x dilations (1, 3, 5), T short with a ragged last tile. Then the
wrapper's checks, the dispatch (`wide_conv.takes`: bf16 on the card without
autograd, aligned and contiguous; `BigVGAN.stage_route`: unfused, resblock
"1"), the stage loop through K6 against the stage loop without it, and the
stage spans' `fused=False`. Inputs come from numpy seeds.

On the card (`-m gpu`): K6's mean error against an f32 reference at most
1.02x that of cuDNN's bf16 conv with the bf16 sums, at the served shapes;
the `wide_conv` counter per eager call and per replay (72 per batch-8
vocoder forward); the full-width bf16 vocoder through K6 against the same
vocoder without it, each against its f32 forward.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiolcm_torch import obs
from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig
from audiolcm_torch.nn import wide_conv as W
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (768, 384, 192, 96)
KS, DS = (3, 7, 11), (1, 3, 5)


def _rand(seed, *shape, scale=1.0):
    return torch.from_numpy(
        (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32))


def _conv_case(c, k, d, t, seed):
    """a, x (the residual), acc (B, C, T); the packed weight, the bias."""
    a, x, acc = (_rand(seed + i, 1, c, t) for i in range(3))
    w = _rand(seed + 3, c, c, k, scale=(c * k) ** -0.5)
    return a, x, acc, w, _rand(seed + 4, c, scale=0.1)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", DS)
def test_tile_walk_matches_conv1d_and_the_resblock_sums_f32(c, k, d):
    """T = 136: one full 128-sample block and a ragged one of 8; every tile
    of the kernel appears across the cases. The four launches a stage makes:
    convs1 (conv + bias), convs2 (x + conv + bias), a resblock's last convs2
    (acc + x + conv + bias) and the stage's last ((acc + x + h) / nk)."""
    t, nk = 136, 3
    a, x, acc, w, bias = _conv_case(c, k, d, t, seed=c + 10 * k + d)
    tile = W.TILES[(k + d + c) % len(W.TILES)]
    h = F.conv1d(a, w, bias, padding=(k - 1) // 2 * d, dilation=d)
    wp = W.pack_weight(w)
    for kw, want in (({}, h), ({"res": x}, x + h), ({"res": x, "acc": acc}, acc + (x + h)),
                     ({"res": x, "acc": acc, "scale": 1 / nk}, (acc + (x + h)) / nk)):
        got = W.wide_conv_tiles_emulated(a, wp, bias, d, tile=tile, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(W.wide_conv_plain(a, wp, bias, d, **kw).numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_tile_walk_rounds_once_in_bf16():
    """bf16 in, f32 sums, one rounding at the store: the emulation equals the
    f32 result rounded to bf16 (the plain version), not a chain of bf16 sums."""
    a, x, acc, w, bias = _conv_case(192, 7, 3, 264, seed=5)
    a, x, acc, w, bias = (v.bfloat16() for v in (a, x, acc, w, bias))
    wp = W.pack_weight(w)
    got = W.wide_conv_tiles_emulated(a, wp, bias, 3, res=x, acc=acc, scale=1 / 3)
    want = W.wide_conv_plain(a, wp, bias, 3, res=x, acc=acc, scale=1 / 3)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7 * want.float().abs().max()


def test_tiles_and_kernel_source_agree():
    """The constants the kernel holds match the wrapper's, each tile of
    TILES is a case of the launch switch, and the tile choice splits the
    served widths into whole tiles."""
    src = open(os.path.join(ROOT, "audiolcm_torch", "csrc", "wide_conv.cu")).read()
    for name in ("BK", "BM"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == getattr(W, name)
    assert int(re.search(r"constexpr int XWIN = (\d+);", src).group(1)) == W.XWIN
    assert W.MAX_REACH == 32 and W.reaches(KS, [DS] * 3) and not W.reaches((67,), [(1,)])
    assert sorted(int(n) for n in re.findall(r"case (\d+): return launch<", src)) == sorted(W.TILES)
    assert re.search(r"BLOCKS_PER_SM = N <= (\d+) \? 2 : 1", src).group(1) == "96"
    assert W.BLOCKS_PER_SM == {n: 2 if n <= 96 else 1 for n in W.TILES}
    for c, b, t in ((768, 8, 2496), (384, 8, 9984), (192, 8, 19968), (96, 8, 39936),
                    (768, 1, 4992), (384, 1, 19968), (192, 1, 39936), (96, 1, 79872),
                    (768, 1, 1248), (96, 1, 19968)):
        n = W.pick_tile(c, b, t)
        assert n in W.TILES and c % n == 0
    assert W.pick_tile(200, 1, 64) in W.TILES  # no tile splits 200: padded


def test_wrapper_validation_and_cpu_path():
    a, x, acc, w, bias = _conv_case(96, 3, 1, 64, seed=1)
    wp = W.pack_weight(w)
    before = obs.counters()
    assert torch.equal(W.wide_conv(a, wp, bias, 1, res=x), W.wide_conv_plain(a, wp, bias, 1, res=x))
    assert obs.counters() == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match=r"\(B, C, T\)"):
        W.wide_conv(a[0], wp, bias, 1)
    with pytest.raises(ValueError, match="k odd"):
        W.wide_conv(a, W.pack_weight(_rand(2, 96, 96, 4)), bias, 1)
    with pytest.raises(ValueError, match="bias"):
        W.wide_conv(a, wp, bias[:5], 1)
    with pytest.raises(ValueError, match="dilation"):
        W.wide_conv(a, wp, bias, 0)
    with pytest.raises(ValueError, match="res must be"):
        W.wide_conv(a, wp, bias, 1, res=x[..., :32])
    with pytest.raises(TypeError, match="one dtype"):
        W.wide_conv(a, wp, bias, 1, acc=acc.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        W.wide_conv(a, wp, bias, 1, res=x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        W.wide_conv(a.to("meta"), wp.to("meta"), bias.to("meta"), 1)


class _Stub:
    """What `takes` reads of a tensor, with a device it may claim."""

    def __init__(self, cuda=True, dtype=torch.bfloat16, shape=(2, 96, 64), contiguous=True):
        self.is_cuda, self.dtype, self.shape, self._c = cuda, dtype, shape, contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._c


def test_takes_only_bf16_on_the_card_without_autograd_aligned():
    with torch.no_grad():
        assert W.takes(_Stub())
        assert not W.takes(_Stub(cuda=False))  # the CPU
        assert not W.takes(_Stub(dtype=torch.float32))  # f32: trainers, TF32 off
        assert not W.takes(_Stub(shape=(2, 96, 60)))  # T off TMA's 16-byte rows
        assert not W.takes(_Stub(shape=(2, 92, 64)))
        assert not W.takes(_Stub(contiguous=False))
    assert torch.is_grad_enabled() and not W.takes(_Stub())  # autograd: the GAN trainer
    with torch.inference_mode():
        assert W.takes(_Stub())
    assert not W.takes(torch.zeros(2, 96, 64, dtype=torch.bfloat16))


def _vocoder(seed=3, **knobs):
    """The shipped config at full width; weights at the JAX init's scale
    (0.01), biases and snakes 0.1 N, from a numpy seed."""
    torch.manual_seed(seed)
    voc = BigVGAN(BigVGANConfig(), **knobs)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in voc.parameters():
            p.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) * (0.01 if p.dim() > 1 else 0.1))
                .astype(np.float32)))
    return voc.eval()


@pytest.fixture
def k6_on_the_cpu(monkeypatch):
    """`takes` answering yes on the CPU (the wrapper then runs its plain
    version there), and a log of the convs it ran."""
    calls = []
    real = W.wide_conv

    def logged(a, w, bias, dilation, res=None, acc=None, scale=1.0):
        calls.append((a.shape[1], dilation, res is not None, acc is not None, scale))
        return real(a, w, bias, dilation, res=res, acc=acc, scale=scale)

    monkeypatch.setattr(W, "takes", lambda x: not torch.is_grad_enabled())
    monkeypatch.setattr(W, "wide_conv", logged)
    return calls


def test_stage_loop_through_k6_matches_the_stage_loop_without_it(k6_on_the_cpu, monkeypatch):
    """f32 on the CPU, the serving knob (K1 fuses C <= 48): the unfused
    stages through the K6 route (its plain version here) equal the torch
    route within float rounding; 18 convs per unfused stage, convs2 with the
    residual, each resblock's last with the running sum, the stage's last
    scaled by 1/3; the fused stages and the stage spans as before."""
    mel = _rand(4, 1, 12, 80, scale=0.3)
    voc = _vocoder(pallas_stage_max_channels=48)
    with torch.no_grad():
        via_k6 = voc(mel)
    calls = list(k6_on_the_cpu)
    k6_on_the_cpu.clear()
    monkeypatch.setattr(W, "takes", lambda x: False)
    with torch.no_grad():
        without = voc(mel)
    assert not k6_on_the_cpu
    np.testing.assert_allclose(via_k6.numpy(), without.numpy(), atol=2e-5)
    assert [c for c, *_ in calls] == [c for c in WIDTHS for _ in range(18)]
    per_stage = calls[:18]
    assert [d for _, d, *_ in per_stage] == [d if i % 2 == 0 else 1
                                           for _ in KS for d in DS for i in (0, 1)]
    assert [r for _, _, r, _, _ in per_stage] == [False, True] * 9
    assert [a for _, _, _, a, _ in per_stage] == [False] * 5 + [False] + [False] * 5 + [True] \
        + [False] * 5 + [True]
    assert [s for *_, s in per_stage] == [1.0] * 17 + [pytest.approx(1 / 3)]


def test_stage_spans_keep_fused_false_on_k6_stages(k6_on_the_cpu):
    mel = _rand(5, 1, 8, 80, scale=0.3)
    voc = _vocoder(pallas_stage_max_channels=48)
    obs.reset()
    with torch.no_grad():
        voc(mel)
    by_name = {s["name"]: s for s in obs.snapshot()["spans"]
               if s["name"].startswith("vocoder.stage")}
    assert [by_name[f"vocoder.stage{i}"]["fused"] for i in range(6)] == [False] * 4 + [True] * 2
    assert [by_name[f"vocoder.stage{i}"]["C"] for i in range(4)] == list(WIDTHS)
    assert len(k6_on_the_cpu) == 72


def test_resblock_2_and_autograd_keep_the_torch_convs(k6_on_the_cpu):
    """Resblock "2" never reaches K6; nor does a forward under autograd (the
    vocoder-GAN trainer)."""
    mel = _rand(6, 1, 8, 80, scale=0.3)
    voc = BigVGAN(BigVGANConfig(resblock="2"), pallas_stage_max_channels=48).eval()
    with torch.no_grad():
        voc(mel)
    assert not k6_on_the_cpu
    voc = BigVGAN(BigVGANConfig(), pallas_stage_max_channels=48)
    voc(mel)  # autograd on
    assert not k6_on_the_cpu


def test_packed_weights_follow_the_weights(k6_on_the_cpu):
    """`wide_weights` packs once per weight version and again after an
    in-place update (a checkpoint load); `pack_stage_weights` packs the blocks
    of the stages that take the "wide" route only."""
    torch.manual_seed(0)
    voc = BigVGAN(BigVGANConfig(), pallas_stage_max_channels=48)
    blk = voc.resblocks[0]
    first = blk.wide_weights()
    assert blk.wide_weights() is first
    assert torch.equal(first[0], W.pack_weight(blk.convs1[0].weight))
    with torch.no_grad():
        blk.convs2[2].weight.mul_(2.0)
    again = blk.wide_weights()
    assert again is not first and torch.equal(again[5], W.pack_weight(blk.convs2[2].weight))
    voc.resblocks[0]._wide = None
    voc.pack_stage_weights()
    assert all((blk._wide is not None) == (i < 12) for i, blk in enumerate(voc.resblocks))
    with torch.inference_mode():  # inference tensors keep no version: packed by storage
        voc = voc.to(torch.bfloat16)
        blk = voc.resblocks[0]
        assert blk.wide_weights() is blk.wide_weights()
        assert torch.equal(blk.wide_weights()[0], W.pack_weight(blk.convs1[0].weight))


@pytest.fixture
def meta_is_the_card(monkeypatch):
    """The real `takes` with the meta device standing for the card (this
    machine's torch may have no CUDA)."""
    real = W.takes
    monkeypatch.setattr(W, "takes", lambda x: real(_Stub(
        cuda=x.device.type == "meta", dtype=x.dtype, shape=tuple(x.shape),
        contiguous=x.is_contiguous())))


CARD, CPU, BF16, F32 = "meta", "cpu", torch.bfloat16, torch.float32


@pytest.mark.parametrize("c,dtype,device,grad,frames,knob,resblock,route", [
    (768, BF16, CARD, False, 16, 48, "1", "wide"),
    (768, BF16, CARD, True, 16, 48, "1", "torch"),  # autograd: the GAN trainer
    (768, F32, CARD, False, 16, 48, "1", "torch"),
    (768, BF16, CPU, False, 16, 48, "1", "torch"),
    (768, BF16, CARD, False, 17, 48, "1", "torch"),  # T = 68: off TMA's 16-byte rows
    (48, BF16, CARD, False, 16, 48, "1", "fused"),
    (48, F32, CPU, False, 16, 48, "1", "fused"),
    (96, BF16, CARD, False, 16, 96, "1", "wide"),  # no K1 tile at C = 96 in bf16
    (48, BF16, CARD, False, 16, 0, "1", "wide"),
    (768, BF16, CARD, False, 16, 48, "2", "torch")])
def test_stage_route_reads_each_observable(meta_is_the_card, c, dtype, device, grad, frames,
                                          knob, resblock, route):
    """`BigVGAN.stage_route` for one stage of the shipped widths, one
    observable changed per row against the first (the route the stage loop,
    `pack_stage_weights`, the stage spans and the launch predictions take)."""
    with torch.device("meta"):  # no weights: the route reads the config and the shapes
        voc = BigVGAN(BigVGANConfig(resblock=resblock), pallas_stage_max_channels=knob)
    i = (768, 384, 192, 96, 48, 24).index(c)
    with torch.set_grad_enabled(grad):
        assert voc.stage_route(i, dtype, torch.device(device), frames) == route


# ----------------------------------------------------------------- on the card

# the served stage inputs: the b8 10 s generate's unfused stages (batch 8,
# mel 624) and the b1 20 s class's (batch 1, mel 1248)
SERVED = [(8, 768, 2496), (8, 384, 9984), (8, 192, 19968), (8, 96, 39936),
          (1, 768, 4992), (1, 384, 19968), (1, 192, 39936), (1, 96, 79872)]


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device "
                    "(run: python -m pytest -m gpu tests/test_torch_wide_conv.py)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the f32 references
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda:0")


def _launches():
    return obs.counters().get("wide_conv", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,t", SERVED)
def test_kernel_error_at_most_cudnn_and_bf16_sums_on_card(cuda_device, b, c, t):
    """A resblock's last conv of the stage's last resblock, as served: K6
    against an f32 reference from the same bf16 inputs, mean error at most
    1.02x that of cuDNN's bf16 conv followed by the bf16 sums it replaces
    (x + h, acc + that, / 3); the plain conv (convs1, dilation 5) too. One
    launch per call."""
    g = torch.Generator(cuda_device).manual_seed(t + c)
    k, nk = 11, 3
    a, x, acc = (torch.randn(b, c, t, generator=g, device=cuda_device).bfloat16()
                 for _ in range(3))
    w = (torch.randn(c, c, k, generator=g, device=cuda_device) * (c * k) ** -0.5).bfloat16()
    bias = (0.1 * torch.randn(c, generator=g, device=cuda_device)).bfloat16()
    wp = W.pack_weight(w)
    with torch.inference_mode():
        for d, kw in ((5, {}), (1, {"res": x, "acc": acc, "scale": 1 / nk})):
            pad = (k - 1) // 2 * d
            ref = F.conv1d(a.float(), w.float(), bias.float(), padding=pad, dilation=d)
            h = F.conv1d(a, w, bias, padding=pad, dilation=d)
            if kw:
                ref = (acc.float() + x.float() + ref) / nk
                h = (acc + (x + h)) / nk
            n0 = _launches()
            got = W.wide_conv(a, wp, bias, d, **kw)
            torch.cuda.synchronize()
            assert _launches() == n0 + 1
            k6_err = (got.float() - ref).abs().mean().item()
            assert k6_err <= 1.02 * (h.float() - ref).abs().mean().item(), (d, k6_err)


def _card_vocoder(cuda_device, dtype):
    return _vocoder(pallas_stage_max_channels=48).to(device=cuda_device, dtype=dtype)


@pytest.mark.gpu
def test_counter_reads_72_per_vocoder_forward_and_per_replay_on_card(cuda_device):
    """The serving vocoder at batch 8 in bf16: 72 K6 launches per eager
    forward (4 stages x 3 resblocks x 6 convs) and per replay of a captured
    forward, and the replay's waveform equals the eager one."""
    voc = _card_vocoder(cuda_device, torch.bfloat16)
    mel = torch.randn(8, 32, 80, device=cuda_device).bfloat16()
    with torch.inference_mode():
        n0 = _launches()
        eager = voc(mel)
        torch.cuda.synchronize()
        assert _launches() == n0 + 72
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            voc(mel)
        torch.cuda.current_stream(cuda_device).wait_stream(side)
        with obs.capture(cuda_device) as tally, torch.cuda.graph(graph):
            out = voc(mel)
        assert tally.counts.get("wide_conv") == 72
        n1 = _launches()
        for _ in range(3):
            with obs.launch(tally):
                graph.replay()
        torch.cuda.synchronize()
        assert _launches() == n1 + 3 * 72
        assert torch.equal(out, eager)


@pytest.mark.gpu
def test_full_width_vocoder_through_k6_against_the_cudnn_route_on_card(cuda_device, monkeypatch):
    """The full-width serving vocoder at batch 2 on a 2.5 s mel in bf16,
    through K6 and with K6 turned off (cuDNN and the bf16 sums), each
    against the same vocoder's f32 forward (TF32 off): K6's mean waveform
    error at most 1.02x the cuDNN route's. (Two bf16 routes cannot meet the
    2e-5 of the f32 CPU parity tests; this is the bar the port holds its
    bf16 kernels to.)"""
    mel = torch.from_numpy((0.3 * np.random.default_rng(9).standard_normal((2, 156, 80)))
                           .astype(np.float32)).to(cuda_device)
    with torch.inference_mode():
        ref = _card_vocoder(cuda_device, torch.float32)(mel)
        voc = _card_vocoder(cuda_device, torch.bfloat16)
        n0 = _launches()
        k6 = voc(mel.bfloat16()).float()
        assert _launches() == n0 + 72
        monkeypatch.setattr(W, "takes", lambda x: False)
        cudnn = voc(mel.bfloat16()).float()
    k6_err, cudnn_err = (k6 - ref).abs().mean().item(), (cudnn - ref).abs().mean().item()
    assert k6_err <= 1.02 * cudnn_err, (k6_err, cudnn_err)
