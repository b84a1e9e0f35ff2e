"""BigVGAN generator: mel (B, T, 80) -> waveform (B, 256*T).

Reference `vocoder/bigvgan/models.py` with the shipped 16 kHz config:
conv_pre k7 -> 6 transposed-conv upsample stages (rates 4,4,2,2,2,2,
kernels 8,8,4,4,4,4, channels halving from 1536), each followed by the mean
of 3 AMP resblocks (kernels 3,7,11, dilations 1,3,5) -> snakebeta ->
conv_post k7 -> tanh. Checkpoint weights arrive with weight_norm folded
(`convert.fold_weight_norm`).

The module takes channels-last mel and runs channels-first (B, C, T)
inside. `BigVGAN.stage_route` sends each upsample stage down one of three
routes, decided before any launch from what the stage can observe:
  * "fused" — stages with C <= `pallas_stage_max_channels` (resblock "1",
    snakebeta, one dilation tuple) run as one fused AMP stage
    (nn/amp_stage.py: the sm_90a kernel K1 on the card, its plain version
    on the CPU) when the kernel route of their dtype has a tile for that C
    (`amp_stage.route_takes`), as JAX runs a stage unfused when no tile
    fits. Its parameters are packed for the kernel once per weight version
    when no gradient is recorded (`BigVGAN.fused_params`); the pipeline
    packs them when it is built (`BigVGAN.pack_stage_weights`), so a
    replay runs only the stage's kernel;
  * "wide" — the other stages of resblock "1" run every resblock conv as
    one launch of the sm_90a kernel K6 (nn/wide_conv.py) when the stage's
    upsampled input is bf16 on the card, no gradient is recorded, T meets
    TMA's alignment (`wide_conv.takes`) and the convs' reach fits its
    window (`wide_conv.reaches`): `convs2[i]` adds the residual in its
    epilogue, a resblock's last conv also the stage's running resblock sum,
    and the stage's last conv scales by 1 / len(resblocks). Its weights are
    packed once per weight version (`AMPBlock1.wide_weights`); the pipeline
    packs them when it is built (`BigVGAN.pack_stage_weights`);
  * "torch" — every other stage runs torch's convs.
Every alias-free activation outside a fused stage, and `activation_post`,
is one launch of the sm_90a kernel K5 (nn/alias_free_act.py) when x is on
the card and no gradient is recorded, whatever the stage's width.
Otherwise (on the CPU, or under autograd: the vocoder-GAN trainer) an
activation of C <= CF_STAGE_MAX_CHANNELS uses the polyphase channels-first
snake (`resample_cf.alias_free_snake_cf`), a wider one, and every one of
resblock "2", the depthwise-conv alias-free activation: the JAX package's
channels-first and channels-last stages, the same function up to float
rounding, as is K5.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import torch
from torch import nn

from audiolcm_torch import obs
from audiolcm_torch.nn import wide_conv
from audiolcm_torch.nn.alias_free_act import alias_free_act
from audiolcm_torch.nn.amp_stage import PackedStage, fused_amp_stage, pack_stage, route_takes
from audiolcm_torch.nn.packing import weights_version
from audiolcm_torch.nn.resample import alias_free_activation_cf
from audiolcm_torch.nn.resample_cf import alias_free_snake_cf
from audiolcm_torch.nn.snake import Snake, SnakeBeta

CF_STAGE_MAX_CHANNELS = 48  # the widest activation in the polyphase form off the card


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 80
    upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    resblock: str = "1"
    # serving option: polynomial cos in the snakes (nn/snake.py:fast_cos)
    fast_snake: bool = False

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def ConvTranspose1dTorchParity(cin: int, cout: int, kernel_size: int, stride: int):
    """torch ConvTranspose1d(k, stride=u, padding=(k-u)//2): output T*u."""
    return nn.ConvTranspose1d(cin, cout, kernel_size, stride, padding=(kernel_size - stride) // 2)


def _same_conv(c: int, k: int, d: int = 1) -> nn.Conv1d:
    return nn.Conv1d(c, c, k, dilation=d, padding=(k * d - d) // 2)


class Activation1d(nn.Module):
    """Alias-free activation holder (`activations.N.act.{alpha,beta}` keys)."""

    def __init__(self, channels: int, activation: str, logscale: bool, fast: bool,
                 depthwise: bool = False):
        super().__init__()
        cls = SnakeBeta if activation == "snakebeta" else Snake
        self.act = cls(channels, logscale, fast, channel_dim=1)
        # the form off the card and under autograd; depthwise=True keeps the
        # depthwise conv at every width (resblock "2")
        self.polyphase = not depthwise and channels <= CF_STAGE_MAX_CHANNELS

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T): K5 on the card without autograd; else the channels-first
        snake form where `polyphase`, the depthwise-conv form elsewhere."""
        if x.is_cuda and not torch.is_grad_enabled():
            act = self.act
            beta = act.alpha if isinstance(act, Snake) else act.beta
            return alias_free_act(x, act.alpha, beta, act.alpha_logscale, act.fast)
        if self.polyphase:
            a, b = self.act.linear_params()
            return alias_free_snake_cf(x, a, b, fast=self.act.fast)
        return alias_free_activation_cf(x, self.act)


class AMPBlock1(nn.Module):
    """3x(act -> dilated conv -> act -> conv) residual, on (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 snake_logscale: bool = True, activation: str = "snakebeta",
                 fast_snake: bool = False):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        self.convs1 = nn.ModuleList([_same_conv(channels, kernel_size, d) for d in dilations])
        self.convs2 = nn.ModuleList([_same_conv(channels, kernel_size) for _ in dilations])
        self.activations = nn.ModuleList([
            Activation1d(channels, activation, snake_logscale, fast_snake)
            for _ in range(2 * len(dilations))])
        self._wide: Optional[tuple] = None  # (key, packed weights) for K6

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dilations)):
            h = self.convs1[i](self.activations[2 * i](x))
            h = self.convs2[i](self.activations[2 * i + 1](h))
            x = x + h
        return x

    def wide_weights(self) -> list:
        """convs1 then convs2 weights packed for K6 (`wide_conv.pack_weight`),
        packed again only when their `weights_version` changes."""
        convs = [*self.convs1, *self.convs2]
        key = weights_version(c.weight for c in convs)
        if self._wide is None or self._wide[0] != key:
            self._wide = (key, [wide_conv.pack_weight(c.weight) for c in convs])
        return self._wide[1]

    def forward_wide(self, x: torch.Tensor, acc: Optional[torch.Tensor],
                     scale: float) -> torch.Tensor:
        """The block through K6: returns (acc + block(x)) * scale, the
        stage's running resblock sum (acc None: the block's output alone)."""
        ws, nd = self.wide_weights(), len(self.dilations)
        for i, d in enumerate(self.dilations):
            h = wide_conv.wide_conv(self.activations[2 * i](x), ws[i],
                                    self.convs1[i].bias, d)
            last = i == nd - 1
            x = wide_conv.wide_conv(self.activations[2 * i + 1](h), ws[nd + i],
                                    self.convs2[i].bias, 1, res=x,
                                    acc=acc if last else None, scale=scale if last else 1.0)
        return x

    def stage_params(self, dtype) -> dict:
        """Linear-scale snake params and conv weights for nn/amp_stage.py."""
        subs = []
        for i in range(len(self.dilations)):
            a1, b1 = self.activations[2 * i].act.linear_params()
            a2, b2 = self.activations[2 * i + 1].act.linear_params()
            p = {"a1": a1, "b1": b1, "w1": self.convs1[i].weight, "c1b": self.convs1[i].bias,
                 "a2": a2, "b2": b2, "w2": self.convs2[i].weight, "c2b": self.convs2[i].bias}
            subs.append({k: v.to(dtype) for k, v in p.items()})
        return {"sub": subs}


class AMPBlock2(nn.Module):
    """Lighter 2x(act -> dilated conv) residual variant, on (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 snake_logscale: bool = True, activation: str = "snakebeta",
                 fast_snake: bool = False):
        super().__init__()
        self.convs = nn.ModuleList([_same_conv(channels, kernel_size, d) for d in dilations])
        self.activations = nn.ModuleList([
            Activation1d(channels, activation, snake_logscale, fast_snake, depthwise=True)
            for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, act in zip(self.convs, self.activations):
            x = x + conv(act(x))
        return x


class BigVGAN(nn.Module):
    def __init__(self, config: BigVGANConfig = BigVGANConfig(),
                 pallas_stage_max_channels: int = 0):
        super().__init__()
        cfg = config
        self.config = cfg
        # stages with C <= this run as one fused AMP stage (0 = off); the knob
        # name and default are the JAX package's
        self.pallas_stage_max_channels = pallas_stage_max_channels
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = AMPBlock1 if cfg.resblock == "1" else AMPBlock2
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(nn.ModuleList([ConvTranspose1dTorchParity(c0 // 2**i, ch, k, u)]))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(block(ch, rk, rd, cfg.snake_logscale, cfg.activation,
                                            cfg.fast_snake))
        ch = c0 // (2 ** len(cfg.upsample_rates))
        self.activation_post = Activation1d(ch, cfg.activation, cfg.snake_logscale,
                                            cfg.fast_snake, depthwise=cfg.resblock != "1")
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self._fused: dict = {}  # stage -> (key, PackedStage) for K1

    def stage_route(self, i: int, dtype: torch.dtype, device: torch.device,
                    frames: int) -> str:
        """The route of upsample stage i in a forward of a `frames`-long mel
        in `dtype` on `device`, under the current grad mode: "fused",
        "wide" or "torch" (the module docstring), decided before any launch."""
        cfg = self.config
        ch = cfg.upsample_initial_channel >> (i + 1)
        dil = tuple(cfg.resblock_dilation_sizes[0])
        if (cfg.resblock == "1" and cfg.activation == "snakebeta"
                and ch <= self.pallas_stage_max_channels
                and all(tuple(rd) == dil for rd in cfg.resblock_dilation_sizes)
                and route_takes(dtype, ch, cfg.resblock_kernel_sizes, dil)):
            return "fused"
        t = frames  # conv_pre keeps the length; each transposed conv stretches it
        for (up,) in itertools.islice(self.ups, i + 1):
            t = (t - 1) * up.stride[0] - 2 * up.padding[0] + up.kernel_size[0]
        # the stage's upsampled input as K6 would take it: a fresh conv output
        # (contiguous), here without its batch and so without memory
        upsampled = torch.empty((0, ch, t), dtype=dtype, device=device)
        if (cfg.resblock == "1" and wide_conv.takes(upsampled)
                and wide_conv.reaches(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            return "wide"
        return "torch"

    def fused_params(self, i: int, dtype: torch.dtype, device: torch.device) -> PackedStage:
        """Stage i's parameters packed for `fused_amp_stage` in `dtype` on
        `device` (`amp_stage.pack_stage`). With no gradient recorded, packed
        once per weight version: again only when the dtype, the device or
        the parameters' `weights_version` changes. Under autograd, packed
        anew for each call: its `params` are then the ones the plain
        version differentiates."""
        cfg = self.config
        nk = len(cfg.resblock_kernel_sizes)
        blocks = self.resblocks[i * nk:(i + 1) * nk]
        pack = lambda: pack_stage(  # noqa: E731
            [blk.stage_params(dtype) for blk in blocks], tuple(cfg.resblock_kernel_sizes),
            tuple(cfg.resblock_dilation_sizes[0]), dtype, device)
        if torch.is_grad_enabled():
            return pack()
        key = (dtype, device, weights_version(p for blk in blocks for p in blk.parameters()))
        if i not in self._fused or self._fused[i][0] != key:
            self._fused[i] = (key, pack())
        return self._fused[i][1]

    def pack_stage_weights(self) -> None:
        """Packs the kernels' weights of every stage that takes the "fused"
        (K1) or "wide" (K6) route in a forward without autograd in the
        module's dtype on its device, so that no packing waits for a first
        forward (or falls inside a graph capture)."""
        nk = len(self.config.resblock_kernel_sizes)
        p = next(self.parameters())
        with torch.no_grad():
            for i in range(len(self.ups)):
                # ALIGN frames: every stage's length meets TMA's alignment
                route = self.stage_route(i, p.dtype, p.device, wide_conv.ALIGN)
                if route == "fused":
                    self.fused_params(i, p.dtype, p.device)
                elif route == "wide":
                    for blk in self.resblocks[i * nk:(i + 1) * nk]:
                        blk.wide_weights()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, num_mels) -> waveform (B, 256*T) in [-1, 1]."""
        cfg = self.config
        nk = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel.transpose(1, 2))
        for i, (up,) in enumerate(self.ups):
            ch = cfg.upsample_initial_channel // 2 ** (i + 1)
            route = self.stage_route(i, x.dtype, x.device, mel.shape[1])
            with obs.stage(f"vocoder.stage{i}", x.device, C=ch, fused=route == "fused"):
                blocks = self.resblocks[i * nk:(i + 1) * nk]
                if route == "fused":
                    x = fused_amp_stage(
                        up(x).transpose(1, 2), self.fused_params(i, x.dtype, x.device),
                        tuple(cfg.resblock_kernel_sizes),
                        tuple(cfg.resblock_dilation_sizes[0]), fast=cfg.fast_snake,
                    ).transpose(1, 2)
                    continue
                x = up(x)
                acc = None
                if route == "wide":
                    for n, blk in enumerate(blocks):
                        acc = blk.forward_wide(x, acc, 1.0 / nk if n == nk - 1 else 1.0)
                    x = acc
                else:
                    for blk in blocks:
                        h = blk(x)
                        acc = h if acc is None else acc + h
                    x = acc / nk
        h = self.conv_post(self.activation_post(x))
        return torch.tanh(h)[:, 0, :]
