"""PatchGAN discriminators for VAE training (`audiolcm_tpu/models/
discriminators.py`).

Reference `ldm/modules/discriminator/model.py`: `NLayerDiscriminator2D`
(Pix2Pix, `:98-147`): Conv2d k4 s2 p1 + LeakyReLU(0.2), then (n_layers-1)
x [Conv2d s2 + BatchNorm + LeakyReLU], one stride-1 block and a 1-channel
head, on mel "images" (B, 1, 80, T); the two 1D discriminators over
feature sequences (`:149-202`) and spectrograms (`:205-259`), used by the
VAE loss variants. State dicts keep the reference layout (`main.<i>.*`).

BatchNorm follows flax's `nn.BatchNorm(momentum=0.9)`, not torch's
BatchNorm: the running variance is the *biased* batch variance
(running = 0.9 * running + 0.1 * batch stat), and the caller says per
call whether the batch normalises (`train`) and whether the running stats
advance (`update_stats`): the JAX VAE-GAN step runs its real pass in train
mode and discards that pass's stats. The normalisation is written out in
torch ops, so it is twice differentiable (R1's gradient penalty). Under
torch.distributed the batch statistics are those of the global batch, as
on the JAX package's data mesh (SyncBatchNorm's sums, through the
differentiable all-reduce, so R1's double backward reaches every rank's
inputs); the reference's own config leaves them per rank
(`sync_batchnorm: false`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiolcm_torch.parallel.mesh import is_distributed, world_size

LRELU = 0.2


class FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over every dim but dim 1, with flax's statistics (see the
    module docstring); reference state-dict keys."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def _check_input_dim(self, x):
        pass

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                update_stats: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        update_stats = train if update_stats is None else update_stats
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = [0] + list(range(2, x.dim()))
            if is_distributed():  # the global batch's statistics, as on JAX's data mesh
                from torch.distributed.nn.functional import all_reduce

                sums = all_reduce(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]))
                n = x.numel() // x.shape[1] * world_size()
                mean, mean_sq = sums[0] / n, sums[1] / n
            else:
                mean, mean_sq = x.mean(dim=dims), (x * x).mean(dim=dims)
            var = (mean_sq - mean * mean).clamp_min(0.0)  # flax's fast biased variance
            if update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class ActNorm(nn.Module):
    """Per-channel affine norm with data-dependent init (`model.py:5-87`):
    the first call in training mode sets loc = -mean and scale = 1/(std +
    1e-6) per channel over every other dim (unbiased std), then
    h = scale * (x + loc). `actnorm_init_` does the same explicitly. (The
    reference's reverse and logdet modes have no caller among the
    discriminators.)"""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1))
        self.register_buffer("initialized", torch.tensor(0, dtype=torch.uint8))

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        if self.training and not bool(self.initialized):
            actnorm_init_(self, x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return self.scale.reshape(shape) * (x + self.loc.reshape(shape))


@torch.no_grad()
def actnorm_init_(norm: ActNorm, x: torch.Tensor) -> None:
    dims = [0] + list(range(2, x.dim()))
    mean, std = x.mean(dim=dims), x.std(dim=dims, unbiased=True)
    norm.loc.copy_((-mean).reshape(norm.loc.shape))
    norm.scale.copy_((1.0 / (std + 1e-6)).reshape(norm.scale.shape))
    norm.initialized.fill_(1)


def _init_(module: nn.Module) -> nn.Module:
    """N(0, 0.02) weights (the JAX package's kernel_init), zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            nn.init.normal_(m.weight, 0.0, 0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


class _PatchGAN(nn.Module):
    """`main`: a Sequential of convs, norms and LeakyReLUs; the norms take
    the per-call train / update_stats flags."""

    def forward(self, x: torch.Tensor, train: Optional[bool] = None,
                update_stats: Optional[bool] = None) -> torch.Tensor:
        for layer in self.main:
            if isinstance(layer, (FlaxBatchNorm, ActNorm)):
                x = layer(x, train=train, update_stats=update_stats)
            else:
                x = layer(x)
        return x


class NLayerDiscriminator2D(_PatchGAN):
    """x (B, input_nc, H, W) -> patch logits (B, 1, H', W')."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        conv = lambda cin, cout, s, bias: nn.Conv2d(cin, cout, 4, s, 1, bias=bias)
        layers = [conv(input_nc, ndf, 2, True), nn.LeakyReLU(LRELU)]
        nf_mult = 1
        for n in range(1, n_layers):
            prev, nf_mult = nf_mult, min(2 ** n, 8)
            layers += [conv(ndf * prev, ndf * nf_mult, 2, False),
                       FlaxBatchNorm(ndf * nf_mult), nn.LeakyReLU(LRELU)]
        prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        layers += [conv(ndf * prev, ndf * nf_mult, 1, False), FlaxBatchNorm(ndf * nf_mult),
                   nn.LeakyReLU(LRELU), conv(ndf * nf_mult, 1, 1, True)]
        self.main = _init_(nn.Sequential(*layers))


def _norm1d(c: int, actnorm: bool) -> nn.Module:
    return ActNorm(c) if actnorm else FlaxBatchNorm(c)


class NLayerDiscriminator1dFeats(_PatchGAN):
    """1D PatchGAN over feature sequences (`model.py:149-202`): channel
    counts decrease from input_nc toward 8, kernel 4. x (B, input_nc, L)."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        bias = use_actnorm
        conv = lambda cin, cout, s, b: nn.Conv1d(cin, cout, 4, s, 1, bias=b)
        nf = input_nc // 2
        layers = [conv(input_nc, nf, 2, True), nn.LeakyReLU(LRELU)]
        n = 1
        for n in range(1, n_layers):
            prev, nf = nf, max(nf // 2 ** n, 8)
            layers += [conv(prev, nf, 2, bias), _norm1d(nf, use_actnorm), nn.LeakyReLU(LRELU)]
        for _ in range(2):  # two stride-1 tails (model.py:186-199)
            prev, nf = nf, max(nf // 2 ** n, 8)
            layers += [conv(prev, nf, 1, bias), _norm1d(nf, use_actnorm), nn.LeakyReLU(LRELU)]
        layers.append(conv(nf, 1, 1, True))
        self.main = _init_(nn.Sequential(*layers))


class NLayerDiscriminator1dSpecs(_PatchGAN):
    """1D PatchGAN over spectrograms, mel bins as channels
    (`model.py:205-259`). x (B, input_nc, T)."""

    def __init__(self, input_nc: int = 80, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        bias = use_actnorm
        conv = lambda cin, cout, s, b: nn.Conv1d(cin, cout, 4, s, 1, bias=b)
        layers = [conv(input_nc, ndf, 2, True), nn.LeakyReLU(LRELU)]
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, ndf * min(2 ** n, 8)
            layers += [conv(prev, nf, 2, bias), _norm1d(nf, use_actnorm), nn.LeakyReLU(LRELU)]
        prev, nf = nf, ndf * min(2 ** n_layers, 8)
        layers += [conv(prev, nf, 1, bias), _norm1d(nf, use_actnorm), nn.LeakyReLU(LRELU),
                   conv(nf, 1, 1, True)]
        self.main = _init_(nn.Sequential(*layers))
