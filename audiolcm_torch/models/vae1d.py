"""1D mel VAE (the first stage): mel (B, T, 80) <-> latent (B, T/2, 20).

Reference `ldm/models/autoencoder1d.py` with configs/audiolcm.yaml:48-72
(ch=384, ch_mult=(1,2,4), num_res_blocks=2, down_layers=[0],
attn_layers=[3], which never matches a level, so the only attention is the
mid-block; encoder kernel_size=5, double_z, z_channels=embed_dim=20).
Reproduced quirks:
  * the encoder's res-blocks use the configured kernel_size, the decoder's
    use kernel 3 (Decoder1D does not forward the YAML's kernel_size), while
    the decoder's conv_in/conv_out use the configured 5;
  * mid-block attention scales by channels**-0.5;
  * downsampling pads (0, 1) then convolves k3 stride 2; upsampling is
    nearest-2x + conv k3.

`AutoencoderKL1D.encode_moments`, `decode` and `forward` take and return
channels-last tensors; the blocks inside run channels-first (B, C, T).
`DiagonalGaussian` is the posterior over the [mean | logvar] moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 80
    out_ch: int = 80
    ch: int = 384
    ch_mult: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_layers: Sequence[int] = (3,)
    down_layers: Sequence[int] = (0,)
    kernel_size: int = 5
    z_channels: int = 20
    embed_dim: int = 20
    double_z: bool = True
    dropout: float = 0.0


def _conv(cin: int, cout: int, k: int) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, padding=k // 2)


class ResnetBlock1D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=1e-6)
        self.conv1 = _conv(cin, cout, kernel_size)
        self.norm2 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv2 = _conv(cout, cout, kernel_size)
        self.nin_shortcut = _conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock1D(nn.Module):
    """Single-head attention over time, scale channels**-0.5."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, c, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (_conv(c, c, 1) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        logits = torch.matmul(q.transpose(1, 2), k).to(torch.float32) * x.shape[1] ** -0.5
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        h = torch.matmul(attn, v.transpose(1, 2)).transpose(1, 2)
        return x + self.proj_out(h)


class Downsample1D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv1d(c, c, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1)))


class Upsample1D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = _conv(c, c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.repeat_interleave(x, 2, dim=-1))


class _Mid(nn.Module):
    def __init__(self, c: int, kernel_size: int = 3):
        super().__init__()
        self.block_1 = ResnetBlock1D(c, c, kernel_size)
        self.attn_1 = AttnBlock1D(c)
        self.block_2 = ResnetBlock1D(c, c, kernel_size)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class _DownLevel(nn.Module):
    def __init__(self, cin: int, cout: int, n_blocks: int, kernel_size: int, attn: bool,
                 downsample: bool):
        super().__init__()
        self.block = nn.ModuleList([ResnetBlock1D(cin if i == 0 else cout, cout, kernel_size)
                                    for i in range(n_blocks)])
        self.attn = nn.ModuleList([AttnBlock1D(cout) for _ in range(n_blocks)] if attn else [])
        self.downsample = Downsample1D(cout) if downsample else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h if self.downsample is None else self.downsample(h)


class Encoder1D(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        k = cfg.kernel_size
        self.conv_in = _conv(cfg.in_channels, cfg.ch, k)
        levels, block_in = [], cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            levels.append(_DownLevel(block_in, cfg.ch * mult, cfg.num_res_blocks, k,
                                     i in cfg.attn_layers, i in cfg.down_layers))
            block_in = cfg.ch * mult
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in, k)
        self.norm_out = nn.GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = _conv(block_in, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, in_channels, T) -> (B, 2*z_channels, T')."""
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class _UpLevel(nn.Module):
    def __init__(self, cin: int, cout: int, n_blocks: int, attn: bool, upsample: bool):
        super().__init__()
        self.block = nn.ModuleList(
            [ResnetBlock1D(cin if i == 0 else cout, cout, 3) for i in range(n_blocks)])
        self.attn = nn.ModuleList([AttnBlock1D(cout) for _ in range(n_blocks)] if attn else [])
        self.upsample = Upsample1D(cout) if upsample else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h if self.upsample is None else self.upsample(h)


class Decoder1D(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        up_layers = [i + 1 for i in cfg.down_layers]
        self.conv_in = _conv(cfg.z_channels, block_in, cfg.kernel_size)
        self.mid = _Mid(block_in)
        levels = {}
        for i in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.ch * cfg.ch_mult[i]
            levels[i] = _UpLevel(block_in, block_out, cfg.num_res_blocks + 1,
                                 i in cfg.attn_layers, i in up_layers)
            block_in = block_out
        self.up = nn.ModuleList([levels[i] for i in range(len(cfg.ch_mult))])
        self.norm_out = nn.GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = _conv(block_in, cfg.out_ch, cfg.kernel_size)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, z_channels, T) -> (B, out_ch, T')."""
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class DiagonalGaussian:
    """Posterior from the moments [mean | logvar] on axis `dim` (the last:
    channels-last; 1 for the 2D VAE's NCHW), logvar clipped to [-30, 20]
    (`ldm/modules/distributions/distributions.py:24-64`)."""

    def __init__(self, moments: torch.Tensor, dim: int = -1):
        self.mean, logvar = moments.chunk(2, dim=dim)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps drawn from `generator` unless `noise` is given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        dims = list(range(1, self.mean.dim()))
        return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = list(range(1, self.mean.dim()))
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=dims)


class AutoencoderKL1D(nn.Module):
    """The VAE with its quant convs."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder1D(config)
        self.decoder = Decoder1D(config)
        zc = 2 * config.z_channels if config.double_z else config.z_channels
        self.quant_conv = _conv(zc, 2 * config.embed_dim, 1)
        self.post_quant_conv = _conv(config.embed_dim, config.z_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """mel (B, T, in_channels) -> moments (B, T/2, 2*embed_dim)."""
        return self.quant_conv(self.encoder(x.transpose(1, 2))).transpose(1, 2)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent (B, T, embed_dim) -> mel (B, 2T, out_ch)."""
        h = self.post_quant_conv(z.transpose(1, 2))
        return self.decoder(h).transpose(1, 2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True) -> Tuple[torch.Tensor, DiagonalGaussian]:
        """mel -> (reconstruction, posterior); z is a posterior sample drawn
        from `generator`, or its mode."""
        posterior = DiagonalGaussian(self.encode_moments(x))
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z), posterior
