"""BigVGAN generator: mel (B, T, 80) -> waveform (B, 256*T).

Reference `vocoder/bigvgan/models.py` with the shipped 16 kHz config:
conv_pre k7 -> 6 transposed-conv upsample stages (rates 4,4,2,2,2,2,
kernels 8,8,4,4,4,4, channels halving from 1536), each followed by the mean
of 3 AMP resblocks (kernels 3,7,11, dilations 1,3,5) -> snakebeta ->
conv_post k7 -> tanh. Checkpoint weights arrive with weight_norm folded
(`convert.fold_weight_norm`).

The module takes channels-last mel and runs channels-first (B, C, T)
inside. Stage dispatch follows the JAX package:
  * stages with C <= `pallas_stage_max_channels` (resblock "1", snakebeta,
    one dilation tuple) run as one fused AMP stage (nn/amp_stage.py: the
    sm_90a kernel on the card) when the kernel route of their dtype has a
    tile for that C (`amp_stage.route_takes`), and unfused otherwise, as
    JAX runs a stage unfused when no tile fits;
  * every alias-free activation of an unfused stage, and
    `activation_post`, is one launch of the sm_90a kernel K5
    (nn/alias_free_act.py) when x is on the card and no gradient is
    recorded, whatever the stage's width;
  * otherwise (on the CPU, or under autograd: the vocoder-GAN trainer),
    stages with C <= `cf_max_channels` use the polyphase channels-first
    snake (`resample_cf.alias_free_snake_cf`), wider ones the depthwise-conv
    alias-free activation — the same function up to float rounding, as is K5;
  * at batch 1, `fold_t_segments` >= 2 runs each unfused stage of
    resblock "1" as that many overlapping time segments (nn/fold.py) where
    `fold_legal` holds: exact;
  * `int8_min_channels` > 0 runs the resblock convs of the unfused
    resblock-"1" stages with C >= it that do not use the polyphase form
    (the JAX package's channels-last stages) as dynamic-int8 products
    (nn/int8_conv.py), a parity knob;
  * otherwise every resblock conv of an unfused resblock-"1" stage is one
    launch of the sm_90a kernel K6 (nn/wide_conv.py) when the stage's input
    is bf16 on the card, no gradient is recorded, T meets TMA's alignment
    (`wide_conv.takes`) and the convs' reach fits its window
    (`wide_conv.reaches`): `convs2[i]` adds the residual in its
    epilogue, a resblock's last conv also the stage's running resblock sum,
    and the stage's last conv scales by 1 / len(resblocks). Its weights are
    packed once per weight version (`AMPBlock1.wide_weights`); the pipeline
    packs them when it is built (`BigVGAN.pack_wide_conv`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from audiolcm_torch import obs
from audiolcm_torch.nn import wide_conv
from audiolcm_torch.nn.alias_free_act import alias_free_act
from audiolcm_torch.nn.amp_stage import fused_amp_stage, route_takes, stage_radius
from audiolcm_torch.nn.fold import fold_legal, fold_time, stage_fold_halo, unfold_time
from audiolcm_torch.nn.int8_conv import int8_conv1d_cl
from audiolcm_torch.nn.resample import alias_free_activation_cf
from audiolcm_torch.nn.resample_cf import alias_free_snake_cf
from audiolcm_torch.nn.snake import Snake, SnakeBeta

CF_STAGE_MAX_CHANNELS = 48


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


def _conv(conv: nn.Conv1d, h: torch.Tensor, int8: bool) -> torch.Tensor:
    """conv(h) on (B, C, T), or its dynamic-int8 form."""
    if not int8:
        return conv(h)
    return int8_conv1d_cl(h.transpose(1, 2), conv.weight, conv.bias,
                          conv.dilation[0]).transpose(1, 2)


class Activation1d(nn.Module):
    """Alias-free activation holder (`activations.N.act.{alpha,beta}` keys)."""

    def __init__(self, channels: int, activation: str, logscale: bool, fast: bool):
        super().__init__()
        cls = SnakeBeta if activation == "snakebeta" else Snake
        self.act = cls(channels, logscale, fast, channel_dim=1)

    def forward(self, x: torch.Tensor, polyphase: bool) -> torch.Tensor:
        """(B, C, T): K5 on the card without autograd; else polyphase=True
        uses the channels-first snake form, False the depthwise-conv form."""
        if x.is_cuda and not torch.is_grad_enabled():
            act = self.act
            beta = act.alpha if isinstance(act, Snake) else act.beta
            # contiguous: the int8 route's convs hand back a transposed view
            return alias_free_act(x.contiguous(), act.alpha, beta, act.alpha_logscale, act.fast)
        if polyphase:
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

    def forward(self, x: torch.Tensor, polyphase: bool = True,
                int8: bool = False) -> torch.Tensor:
        for i in range(len(self.dilations)):
            h = _conv(self.convs1[i], self.activations[2 * i](x, polyphase), int8)
            h = _conv(self.convs2[i], self.activations[2 * i + 1](h, polyphase), int8)
            x = x + h
        return x

    def wide_weights(self) -> list:
        """convs1 then convs2 weights packed for K6 (`wide_conv.pack_weight`),
        packed again only when a weight's storage, dtype or version changes
        (a module made inside `torch.inference_mode()` holds inference
        tensors, which keep no version: their packing follows the storage)."""
        convs = [*self.convs1, *self.convs2]
        key = tuple((w.data_ptr(), w.dtype, None if w.is_inference() else w._version)
                    for w in (c.weight for c in convs))
        if self._wide is None or self._wide[0] != key:
            self._wide = (key, [wide_conv.pack_weight(c.weight) for c in convs])
        return self._wide[1]

    def forward_wide(self, x: torch.Tensor, acc: Optional[torch.Tensor],
                     scale: float) -> torch.Tensor:
        """The block through K6: returns (acc + block(x)) * scale, the
        stage's running resblock sum (acc None: the block's output alone)."""
        ws, nd = self.wide_weights(), len(self.dilations)
        for i, d in enumerate(self.dilations):
            h = wide_conv.wide_conv(self.activations[2 * i](x, True), ws[i],
                                    self.convs1[i].bias, d)
            last = i == nd - 1
            x = wide_conv.wide_conv(self.activations[2 * i + 1](h, True), ws[nd + i],
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
            Activation1d(channels, activation, snake_logscale, fast_snake) for _ in dilations])

    def forward(self, x: torch.Tensor, polyphase: bool = False) -> torch.Tensor:
        for conv, act in zip(self.convs, self.activations):
            x = x + conv(act(x, polyphase))
        return x


class BigVGAN(nn.Module):
    def __init__(self, config: BigVGANConfig = BigVGANConfig(),
                 cf_max_channels: int = CF_STAGE_MAX_CHANNELS,
                 pallas_stage_max_channels: int = 0, pallas_stage_accum: str = "bf16",
                 pallas_stage_conv: str = "tap", int8_min_channels: int = 0,
                 fold_t_segments: int = 0):
        super().__init__()
        cfg = config
        self.config = cfg
        self.cf_max_channels = cf_max_channels
        # stages with C <= this run as one fused AMP stage (0 = off); the knob
        # names and defaults are the JAX package's
        self.pallas_stage_max_channels = pallas_stage_max_channels
        self.pallas_stage_accum = pallas_stage_accum
        self.pallas_stage_conv = pallas_stage_conv
        # resblock convs of unfused channels-last stages with C >= this in
        # dynamic int8 (0 = off), and the batch-1 fold's segment count (0 = off)
        self.int8_min_channels = int8_min_channels
        self.fold_t_segments = fold_t_segments
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
                                            cfg.fast_snake)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def _fused(self, ch: int, dtype: torch.dtype) -> bool:
        """Whether the stage of width ch runs as one fused AMP stage: decided
        from shapes and dtype alone, before any launch."""
        cfg = self.config
        dil = tuple(cfg.resblock_dilation_sizes[0])
        return (cfg.resblock == "1" and cfg.activation == "snakebeta"
                and ch <= self.pallas_stage_max_channels
                and all(tuple(rd) == dil for rd in cfg.resblock_dilation_sizes)
                and route_takes(dtype, ch, stage_radius(cfg.resblock_kernel_sizes, dil)))

    def pack_wide_conv(self) -> None:
        """Packs K6's weights of every resblock-"1" stage that runs unfused
        in the module's dtype, so that no packing waits for a first forward
        (or falls inside a graph capture)."""
        cfg, nk = self.config, len(self.config.resblock_kernel_sizes)
        dtype = next(self.parameters()).dtype
        for i in range(len(cfg.upsample_rates)):
            if cfg.resblock == "1" and not self._fused(cfg.upsample_initial_channel >> (i + 1),
                                                      dtype):
                for blk in self.resblocks[i * nk:(i + 1) * nk]:
                    blk.wide_weights()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, num_mels) -> waveform (B, 256*T) in [-1, 1]."""
        cfg = self.config
        nk = len(cfg.resblock_kernel_sizes)
        fold = self.fold_t_segments
        x = self.conv_pre(mel.transpose(1, 2))
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = cfg.upsample_initial_channel // 2 ** (i + 1)
            fused = self._fused(ch, x.dtype)
            with obs.stage(f"vocoder.stage{i}", x.device, C=ch, fused=fused):
                blocks = self.resblocks[i * nk:(i + 1) * nk]
                if fused:
                    sp = [blk.stage_params(x.dtype) for blk in blocks]
                    x = fused_amp_stage(
                        self.ups[i][0](x).transpose(1, 2), sp, tuple(cfg.resblock_kernel_sizes),
                        tuple(cfg.resblock_dilation_sizes[0]), fast=cfg.fast_snake,
                        accum=self.pallas_stage_accum, conv=self.pallas_stage_conv,
                    ).transpose(1, 2)
                    continue
                folded = False
                if fold >= 2 and x.shape[0] == 1 and cfg.resblock == "1":
                    halo = stage_fold_halo(u, k, cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)
                    if fold_legal(x.shape[-1], fold, halo):
                        seg_len = x.shape[-1] // fold
                        x = fold_time(x, fold, halo)
                        folded = True
                x = self.ups[i][0](x)
                polyphase = cfg.resblock == "1" and ch <= self.cf_max_channels
                int8 = cfg.resblock == "1" and not polyphase and 0 < self.int8_min_channels <= ch
                acc = None
                if (cfg.resblock == "1" and not int8 and wide_conv.takes(x)
                        and wide_conv.reaches(cfg.resblock_kernel_sizes,
                                              cfg.resblock_dilation_sizes)):
                    for n, blk in enumerate(blocks):
                        acc = blk.forward_wide(x, acc, 1.0 / nk if n == nk - 1 else 1.0)
                    x = acc
                else:
                    for blk in blocks:
                        h = blk(x, polyphase, int8) if int8 else blk(x, polyphase)
                        acc = h if acc is None else acc + h
                    x = acc / nk
                if folded:
                    x = unfold_time(x, fold, halo * u, seg_len * u)
        polyphase = cfg.resblock == "1" and x.shape[1] <= self.cf_max_channels
        h = self.conv_post(self.activation_post(x, polyphase))
        return torch.tanh(h)[:, 0, :]
