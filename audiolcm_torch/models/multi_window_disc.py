"""Multi-window mel discriminator of the VAE loss variants
(`audiolcm_tpu/models/multi_window_disc.py`).

Reference `ldm/modules/discriminator/multi_window_disc.py`:
`Discriminator2DFactory` (three Conv2d k3 s2 blocks with LeakyReLU 0.2 and
Dropout2d 0.25, then a linear head over the flattened features, `:6-63`),
`MultiWindowDiscriminator` (one such tower per window length over a clip
of the mel, `:66-148`) and the `Discriminator` wrapper (an unconditional
and a conditional tower, x_len from the non-zero frames, `:151-198`). NCHW
as the reference: a mel (B, T, F) enters as (B, 1, T, F) and the convs run
over (T, F). State dicts keep the reference layout
(`discriminator.conv_layers.<i>.model.<j>.{0,3}.*`, `.adv_layer.*`,
`cond_disc.{mel,cond}_proj_layers.<i>.*`).

As in the JAX module:
  * norm "bn" is flax's BatchNorm with the reference's positional eps 0.8
    (`FlaxBatchNorm`, momentum 0.1 = flax's 0.9); "in" an affine
    InstanceNorm over (T, F), eps 1e-5, with flax's statistics
    (`FlaxInstanceNorm`); "sn" no norm and each conv's kernel divided by
    its largest singular value after one step of flax's power iteration
    (`SpectralNormConv2d`);
  * Dropout2d drops whole channels, in train mode only;
  * each window's start is one draw in [0, T) clamped to
    max(max(x_len) - win, 0), the same for the whole batch (not the
    reference's U[0, t_end]); the draws can be passed in (`starts`, one
    per entry of time_lengths) or are taken from `generator`;
  * a window longer than T is dropped, and the towers that remain are
    reduced ("sum", "stack", or "none": per-frame logits concatenated).
Under torch.distributed the clamp uses the longest x_len of the global
batch, as the JAX package's mesh does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.discriminators import FlaxBatchNorm
from audiolcm_torch.parallel.mesh import is_distributed

LRELU = 0.2
DROPOUT = 0.25
SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax's l2_normalize: x * rsqrt(sum(x^2) + eps)."""
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormConv2d(nn.Module):
    """Conv2d with flax's `nn.SpectralNorm`: one power-iteration step from
    the stored u (eps 1e-12 inside the rsqrt), sigma = u^T W v with u and v
    held constant, W / sigma (W when sigma is 0); u and sigma are stored
    when `update_stats`. W is the (out, in*kh*kw) matrix, whose sigma and u
    equal those of flax's (kh*kw*in, out) matrix. Keys: weight_orig, bias
    (the reference's spectral_norm), weight_u (out,) and weight_sigma ()
    (flax's statistics)."""

    def __init__(self, c_in: int, c_out: int, kernel: Tuple[int, int], stride, padding):
        super().__init__()
        conv = nn.Conv2d(c_in, c_out, kernel, stride, padding)
        self.weight_orig = nn.Parameter(conv.weight.detach().clone())
        self.bias = nn.Parameter(conv.bias.detach().clone())
        self.register_buffer("weight_u", torch.randn(c_out))
        self.register_buffer("weight_sigma", torch.ones(()))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        with torch.no_grad():  # flax's one power-iteration step
            v = _l2_normalize(w.T @ self.weight_u, SN_EPS)
            u = _l2_normalize(w @ v, SN_EPS)
        sigma = u @ (w @ v)
        weight = self.weight_orig / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_sigma.copy_(sigma)
        return F.conv2d(x, weight, self.bias, self.stride, self.padding)


class FlaxInstanceNorm(nn.InstanceNorm2d):
    """Affine InstanceNorm over (T, F) with flax GroupNorm(group_size=1)'s
    statistics (the variance as mean(x^2) - mean(x)^2); the reference's
    InstanceNorm2d keys (weight, bias)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = ((x * x).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


def _dropout2d(h: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Whole channels kept with probability 1 - p and scaled by 1 / (1 - p)."""
    if p <= 0:
        return h
    keep = torch.rand(h.shape[:2] + (1, 1), generator=generator, device=h.device) >= p
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype, device=h.device))


class Discriminator2DFactory(nn.Module):
    """One fixed-window tower: (B, C, win, F) -> (validity, hiddens);
    validity (B, 1), or (B, win // 8) per frame when reduction is "none"."""

    def __init__(self, time_length: int, freq_length: int = 80, kernel=(3, 3), c_in: int = 1,
                 hidden_size: int = 128, norm_type: str = "bn", reduction: str = "sum"):
        super().__init__()
        if norm_type not in ("bn", "in", "sn"):
            raise ValueError(f"norm_type {norm_type!r}: expected 'bn', 'in' or 'sn'")
        pad = (kernel[0] // 2, kernel[1] // 2)
        self.norm_type, self.reduction = norm_type, reduction
        blocks = []
        for j in range(3):
            cin = c_in if j == 0 else hidden_size
            conv = (SpectralNormConv2d(cin, hidden_size, kernel, 2, pad) if norm_type == "sn"
                    else nn.Conv2d(cin, hidden_size, kernel, 2, pad))
            layers = [conv, nn.LeakyReLU(LRELU), nn.Dropout2d(DROPOUT)]
            if j > 0 and norm_type == "bn":
                layers.append(FlaxBatchNorm(hidden_size, eps=0.8))  # positional 0.8 is eps
            elif j > 0 and norm_type == "in":
                layers.append(FlaxInstanceNorm(hidden_size))
            blocks.append(nn.Sequential(*layers))
        self.model = nn.ModuleList(blocks)
        ds_t, ds_f = time_length // 2 ** 3, (freq_length + 7) // 2 ** 3
        self.adv_layer = nn.Linear(hidden_size * ds_f * (ds_t if reduction != "none" else 1), 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        hiddens = []
        h = x
        for blk in self.model:
            h = blk[0](h, update_stats=train) if self.norm_type == "sn" else blk[0](h)
            h = blk[1](h)
            if train:
                h = _dropout2d(h, DROPOUT, generator)
            if len(blk) > 3:
                h = blk[3](h, train=train) if self.norm_type == "bn" else blk[3](h)
            hiddens.append(h)
        if self.reduction != "none":
            return self.adv_layer(h.reshape(h.shape[0], -1)), hiddens
        b, _, t, _ = h.shape
        return self.adv_layer(h.transpose(1, 2).reshape(b, t, -1))[..., 0], hiddens


def _max_len(x_len: torch.Tensor) -> torch.Tensor:
    """max(x_len) over the batch (the global batch under torch.distributed)."""
    m = x_len.max()
    if is_distributed():
        import torch.distributed as dist

        m = m.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return m


def draw_starts(n: int, t_total: int, generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """n window-start draws in [0, t_total) (before the clamp)."""
    return torch.randint(0, t_total, (n,), generator=generator, device=device)


class MultiWindowDiscriminator(nn.Module):
    """Random same-start clips per window length -> one tower each."""

    def __init__(self, time_lengths: Sequence[int], cond_size: int = 0, freq_length: int = 80,
                 kernel=(3, 3), c_in: int = 1, hidden_size: int = 128, norm_type: str = "bn",
                 reduction: str = "sum"):
        super().__init__()
        self.win_lengths, self.reduction = tuple(time_lengths), reduction
        self.conv_layers = nn.ModuleList(
            Discriminator2DFactory(w, freq_length, kernel, c_in, hidden_size, norm_type,
                                   reduction) for w in self.win_lengths)
        if cond_size > 0:
            self.cond_proj_layers = nn.ModuleList(
                nn.Linear(cond_size, freq_length) for _ in self.win_lengths)
            self.mel_proj_layers = nn.ModuleList(
                nn.Linear(freq_length, freq_length) for _ in self.win_lengths)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor, cond: Optional[torch.Tensor] = None,
                starts: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, C, T, F), x_len (B,), cond (B, T, cond_size); starts the raw
        draws, one per window length. Returns (validity or None, hiddens)."""
        t_total = x.shape[2]
        if starts is None:
            starts = draw_starts(len(self.win_lengths), t_total, generator, x.device)
        starts = torch.as_tensor(starts, device=x.device)
        longest = _max_len(x_len)
        validity: List[torch.Tensor] = []
        hiddens: List[torch.Tensor] = []
        for i, win in enumerate(self.win_lengths):
            if win > t_total:
                continue
            start = torch.minimum(starts[i], torch.clamp_min(longest - win, 0))
            idx = start + torch.arange(win, device=x.device)
            x_clip = x.index_select(2, idx)
            if cond is not None and hasattr(self, "cond_proj_layers"):
                c_clip = self.cond_proj_layers[i](cond.index_select(1, idx))
                x_clip = self.mel_proj_layers[i](x_clip) + c_clip[:, None]
            v, h = self.conv_layers[i](x_clip, train=train, generator=generator)
            validity.append(v)
            hiddens.extend(h)
        if not validity:
            return None, hiddens
        if self.reduction == "sum":
            return sum(validity), hiddens
        if self.reduction == "stack":
            return torch.stack(validity, dim=-1), hiddens
        return torch.cat(validity, dim=-1), hiddens


class MultiWindowDiscriminatorWrapper(nn.Module):
    """The reference's `Discriminator`: an unconditional tower
    (`discriminator`) and, with cond_size > 0, a conditional one
    (`cond_disc`)."""

    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128), freq_length: int = 80,
                 cond_size: int = 0, kernel=(3, 3), c_in: int = 1, hidden_size: int = 128,
                 norm_type: str = "bn", reduction: str = "sum", uncond_disc: bool = True):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        kw = dict(time_lengths=time_lengths, freq_length=freq_length, kernel=kernel, c_in=c_in,
                  hidden_size=hidden_size, norm_type=norm_type, reduction=reduction)
        if uncond_disc:
            self.discriminator = MultiWindowDiscriminator(**kw)
        if cond_size > 0:
            self.cond_disc = MultiWindowDiscriminator(cond_size=cond_size, **kw)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                x_len: Optional[torch.Tensor] = None, starts: Optional[torch.Tensor] = None,
                starts_c: Optional[torch.Tensor] = None, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """x: mel (B, T, F) or (B, C, T, F). x_len defaults to the count of
        frames whose sum over (C, F) is not 0. starts / starts_c: the
        unconditional / conditional tower's draws."""
        train = self.training if train is None else train
        if x.dim() == 3:
            x = x[:, None]
        if x_len is None:
            x_len = (x.sum(dim=(1, 3)) != 0).sum(dim=-1)
        ret = {"y": None, "y_c": None, "h": [], "h_c": []}
        if hasattr(self, "discriminator"):
            ret["y"], ret["h"] = self.discriminator(x, x_len, starts=starts, train=train,
                                                    generator=generator)
        if hasattr(self, "cond_disc") and cond is not None:
            ret["y_c"], ret["h_c"] = self.cond_disc(x, x_len, cond, starts=starts_c, train=train,
                                                    generator=generator)
        return ret
