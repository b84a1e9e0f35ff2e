"""2D mel-as-image VAE and its VQ variant: the Stable-Diffusion-style first
stage (reference `ldm/models/autoencoder.py:15,306` with
`ldm/modules/diffusionmodules/model.py:368-606`).

A 3x3 stem, res-blocks per resolution with attention at the configured
`attn_resolutions`, a downsample at every level but the last (pad the
bottom and right by 1, then a 3x3 conv of stride 2 without padding), a
symmetric decoder with nearest-neighbour 2x upsampling, a mid-block of
res-block, attention and res-block, GroupNorm(32, eps 1e-6) and swish
throughout. The attention runs over the H*W positions with scale C^-0.5
and its softmax in float32.

Layout NCHW: a mel is (B, 1, 80, T). Parameters in the reference layout
(the 1D VAE's names: `encoder.down.<i>.block.<j>`, `mid.attn_1`, ...;
`quantize.embedding.weight` for the codebook). `dropout` is read and never
applied, as in the JAX package, whose callers all run it deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.vae1d import DiagonalGaussian


@dataclasses.dataclass(frozen=True)
class VAE2DConfig:
    in_channels: int = 1
    out_ch: int = 1
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Sequence[int] = ()
    resolution: int = 80
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    dropout: float = 0.0


def _conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = _norm(cin), _conv(cin, cout)
        self.norm2, self.conv2 = _norm(cout), _conv(cout, cout)
        self.nin_shortcut = _conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock2D(nn.Module):
    """Single-head attention over the H*W positions."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q, self.k, self.v, self.proj_out = (_conv(c, c, 1) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x)
        tokens = lambda a: a.reshape(b, c, hh * ww).transpose(1, 2)
        q, k, v = tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h))
        logits = torch.matmul(q, k.transpose(1, 2)).to(torch.float32) * c ** -0.5
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(out)


class Downsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = _conv(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock2D(c, c)
        self.attn_1 = AttnBlock2D(c)
        self.block_2 = ResnetBlock2D(c, c)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """One resolution's res-blocks (each followed by attention when `attn`)
    and its resampler (`downsample` or `upsample`, or none)."""

    def __init__(self, cin: int, cout: int, n_blocks: int, attn: bool,
                 resample: Optional[str]):
        super().__init__()
        self.block = nn.ModuleList([ResnetBlock2D(cin if i == 0 else cout, cout)
                                    for i in range(n_blocks)])
        self.attn = nn.ModuleList([AttnBlock2D(cout) for _ in range(n_blocks)] if attn else [])
        if resample == "downsample":
            self.downsample = Downsample2D(cout)
        elif resample == "upsample":
            self.upsample = Upsample2D(cout)
        self.resample = resample

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h if self.resample is None else getattr(self, self.resample)(h)


class Encoder2D(nn.Module):
    def __init__(self, cfg: VAE2DConfig):
        super().__init__()
        n = len(cfg.ch_mult)
        self.conv_in = _conv(cfg.in_channels, cfg.ch)
        levels, block_in = [], cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            levels.append(_Level(block_in, cfg.ch * mult, cfg.num_res_blocks,
                                 cfg.resolution // 2 ** i in cfg.attn_resolutions,
                                 "downsample" if i != n - 1 else None))
            block_in = cfg.ch * mult
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in)
        self.norm_out = _norm(block_in)
        self.conv_out = _conv(block_in, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class Decoder2D(nn.Module):
    def __init__(self, cfg: VAE2DConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = _conv(cfg.z_channels, block_in)
        self.mid = _Mid(block_in)
        levels = {}
        for i in reversed(range(len(cfg.ch_mult))):
            block_out = cfg.ch * cfg.ch_mult[i]
            levels[i] = _Level(block_in, block_out, cfg.num_res_blocks + 1,
                               cfg.resolution // 2 ** i in cfg.attn_resolutions,
                               "upsample" if i != 0 else None)
            block_in = block_out
        self.up = nn.ModuleList([levels[i] for i in range(len(cfg.ch_mult))])
        self.norm_out = _norm(block_in)
        self.conv_out = _conv(block_in, cfg.out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL2D(nn.Module):
    """The KL VAE with its quant convs; moments are [mean | logvar] on the
    channel axis."""

    def __init__(self, config: VAE2DConfig = VAE2DConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder2D(config)
        self.decoder = Decoder2D(config)
        zc = 2 * config.z_channels if config.double_z else config.z_channels
        self.quant_conv = nn.Conv2d(zc, 2 * config.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(config.embed_dim, config.z_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, 2*embed_dim, H', W')."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True,
                noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, DiagonalGaussian]:
        """-> (reconstruction, posterior); z is a posterior sample (noise
        drawn from `generator` unless given) or its mode."""
        posterior = DiagonalGaussian(self.encode_moments(x), dim=1)
        z = posterior.sample(generator, noise) if sample_posterior else posterior.mode()
        return self.decode(z), posterior


class VectorQuantizer(nn.Module):
    """Nearest codebook entry with straight-through gradients; loss =
    codebook + beta * commitment."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def distances(self, flat: torch.Tensor) -> torch.Tensor:
        """|z|^2 - 2 z.e + |e|^2 per row of flat (N, embed_dim) and code, in
        that order of operations."""
        cb = self.embedding.weight
        return (flat.pow(2).sum(1, keepdim=True) - 2 * flat @ cb.T) + cb.pow(2).sum(1)[None, :]

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z (B, C, H, W) -> (quantized (B, C, H, W), loss, indices (B, H, W));
        a tie goes to the first code."""
        zl = z.permute(0, 2, 3, 1)
        idx = torch.argmin(self.distances(zl.reshape(-1, self.embed_dim)), dim=1)
        q = self.embedding.weight[idx].reshape(zl.shape)
        commit = torch.mean((q.detach() - zl) ** 2)
        codebook = torch.mean((q - zl.detach()) ** 2)
        q = zl + (q - zl).detach()
        return q.permute(0, 3, 1, 2), codebook + self.beta * commit, idx.reshape(zl.shape[:-1])


class VQModel2D(nn.Module):
    def __init__(self, config: VAE2DConfig = VAE2DConfig(double_z=False), n_embed: int = 8192):
        super().__init__()
        self.config = config
        self.encoder = Encoder2D(config)
        self.decoder = Decoder2D(config)
        zc = 2 * config.z_channels if config.double_z else config.z_channels
        self.quant_conv = nn.Conv2d(zc, config.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(config.embed_dim, config.z_channels, 1)
        self.quantize = VectorQuantizer(n_embed, config.embed_dim)

    def encode(self, x: torch.Tensor):
        return self.quantize(self.quant_conv(self.encoder(x)))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(quant))

    def forward(self, x: torch.Tensor):
        """-> (reconstruction, loss, indices)."""
        quant, loss, idx = self.encode(x)
        return self.decode(quant), loss, idx
