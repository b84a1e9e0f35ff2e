"""BigVGAN discriminators: multi-period (MPD) and multi-resolution (MRD)
(`audiolcm_tpu/models/vocoder_discriminators.py`).

Reference `vocoder/bigvgan/models.py:216-355` with the 16 kHz config:
  * DiscriminatorP per period in (2, 3, 5, 7, 11): the wav reflect-padded to
    a multiple of the period and folded to (B, 1, T/p, p); a Conv2d (5, 1)
    stride-(3, 1) stack with LeakyReLU(0.1), feature maps kept for the
    feature-matching loss.
  * DiscriminatorR per STFT resolution ((1024, 120, 600), (2048, 240, 1200),
    (512, 50, 240)): rectangular-window magnitude STFT (`dsp/mel.py`), a
    Conv2d (3, 9) stack with stride (1, 2), LeakyReLU(0.1). As in the JAX
    package, the magnitude is laid out (B, 1, frames, bins): the kernel's
    3 spans frames and its 9 spans bins (BigVGAN lays it out (bins,
    frames)).
The reference's convs are weight-normed; here, as in the JAX package, they
are plain convs, and a reference state dict loads after
`convert.fold_weight_norms`. State dicts keep the reference layout
(`discriminators.<i>.convs.<j>`, `.conv_post`). Feature maps are
channels-first (B, C, H, W); the losses are element means, so they equal
the JAX package's channels-last ones. Not ported: the JAX modules'
layout experiments that no trainer selects (DiscriminatorP's
fold_mode="batch", DiscriminatorR's stft_matmul).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.dsp.mel import stft_magnitude

LRELU_SLOPE = 0.1
MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def _init_(module: nn.Module) -> nn.Module:
    """N(0, 0.01) weights (the JAX package's kernel_init), zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.normal_(m.weight, 0.0, 0.01)
            nn.init.zeros_(m.bias)
    return module


def _stack(convs: nn.ModuleList, post: nn.Conv2d, x: torch.Tensor
           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    fmap = []
    for conv in convs:
        x = F.leaky_relu(conv(x), LRELU_SLOPE)
        fmap.append(x)
    x = post(x)
    fmap.append(x)
    return x.flatten(1), fmap


class DiscriminatorP(nn.Module):
    """Period-folded 2D conv discriminator (`models.py:216-250`)."""

    def __init__(self, period: int, d_mult: int = 1):
        super().__init__()
        self.period = period
        ch = [1] + [w * d_mult for w in (32, 128, 512, 1024)]
        self.convs = nn.ModuleList(
            [nn.Conv2d(a, b, (5, 1), (3, 1), padding=(2, 0)) for a, b in zip(ch, ch[1:])]
            + [nn.Conv2d(ch[-1], ch[-1], (5, 1), 1, padding=(2, 0))])
        self.conv_post = nn.Conv2d(ch[-1], 1, (3, 1), 1, padding=(1, 0))
        _init_(self)

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """wav (B, T) -> (flattened patch logits, fmaps)."""
        b, t = wav.shape
        p = self.period
        if t % p:
            wav = F.pad(wav[:, None], (0, p - t % p), mode="reflect")[:, 0]
            t = wav.shape[1]
        return _stack(self.convs, self.conv_post, wav.reshape(b, 1, t // p, p))


class DiscriminatorR(nn.Module):
    """STFT-magnitude 2D conv discriminator (`models.py:277-317`)."""

    def __init__(self, resolution: Sequence[int], d_mult: int = 1):
        super().__init__()
        self.resolution = tuple(resolution)
        ch = 32 * d_mult
        specs = [((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
                 ((3, 3), (1, 1))]
        self.convs = nn.ModuleList([
            nn.Conv2d(1 if i == 0 else ch, ch, k, s, padding=(k[0] // 2, k[1] // 2))
            for i, (k, s) in enumerate(specs)])
        self.conv_post = nn.Conv2d(ch, 1, (3, 3), 1, padding=(1, 1))
        _init_(self)

    def forward(self, wav: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        n_fft, hop, win = self.resolution
        pad = (n_fft - hop) // 2
        y = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        window = torch.ones(win, dtype=y.dtype, device=y.device)  # torch.stft window=None
        mag = stft_magnitude(y, window, n_fft, hop, win)  # (B, F, frames)
        return _stack(self.convs, self.conv_post, mag.transpose(1, 2)[:, None])


def apply_pair(d: nn.Module, y: torch.Tensor, y_hat: torch.Tensor, pair_batch: bool):
    """A sub-discriminator on (real, fake) -> (logits_r, logits_g, fmaps_r,
    fmaps_g). pair_batch=True runs the pair as one batch of 2B (shared
    weights, per-sample ops: the same numbers) and splits it back."""
    if not pair_batch:
        (lr, fr), (lg, fg) = d(y), d(y_hat)
        return lr, lg, fr, fg
    b = y.shape[0]
    logits, fmaps = d(torch.cat([y, y_hat], dim=0))
    return logits[:b], logits[b:], [f[:b] for f in fmaps], [f[b:] for f in fmaps]


class _Multi(nn.Module):
    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (reals, fakes, fmap_r, fmap_g), one entry per sub-discriminator."""
        outs = [apply_pair(d, y, y_hat, self.pair_batch) for d in self.discriminators]
        return tuple([o[i] for o in outs] for i in range(4))


class MultiPeriodDiscriminator(_Multi):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), d_mult: int = 1,
                 pair_batch: bool = False):
        super().__init__()
        self.pair_batch = pair_batch
        self.discriminators = nn.ModuleList([DiscriminatorP(p, d_mult) for p in periods])


class MultiResolutionDiscriminator(_Multi):
    def __init__(self, resolutions: Sequence[Sequence[int]] = MRD_RESOLUTIONS, d_mult: int = 1,
                 pair_batch: bool = False):
        super().__init__()
        self.pair_batch = pair_batch
        self.discriminators = nn.ModuleList([DiscriminatorR(r, d_mult) for r in resolutions])
