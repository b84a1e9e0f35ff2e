"""HTSAT, the hierarchical token-semantic audio transformer (Swin), of the
LAION CLAP (`audiolcm_tpu/models/open_clap/htsat.py`).

Reference `ldm/modules/encoders/open_clap/htsat.py`: PatchEmbed with its 2D
feature-fusion branch, WindowAttention with a relative position bias,
SwinTransformerBlock with the cyclic shift, PatchMerging, BasicLayer and
HTSAT_Swin_Transformer: the 48 kHz torchlibrosa log-mel
(`models/clap_audio.logmel_torchlibrosa`), bn0 over the mel bins, the
freq-ratio tiling of `reshape_wav2img`, the 4-stage Swin trunk, the tscam
conv head and the average-pooled `embedding`. Presets tiny / base / large
(`create_htsat_model`).

Layout: the reference's (B, C, H, W) up to the patch embedding, then
(B, L, C) tokens. State-dict keys are the reference's (`bn0`,
`patch_embed.{proj,norm,mel_conv2d,fusion_model}`, `layers.<i>.blocks.<j>.*`,
`layers.<i>.downsample.*`, `norm`, `tscam_conv`, `mel_conv1d.{0,1}`,
`fusion_model`); its buffers (relative position index, shift masks, the
STFT and mel bases) are computed here from the shapes instead.

As in the JAX module: inference only (SpecAugment, mixup and drop-path are
training no-ops and omitted; BatchNorms on running statistics), and the
local fusion of "longer" clips runs over the whole batch and is blended in
with `where(longer, fused, global)`, where the reference indexes the
batch: one static graph, the same numbers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.clap_audio import ClapAudioConfig, bn_eval, logmel_torchlibrosa
from audiolcm_torch.models.open_clap.fusion import fusion_module, run_eval
from audiolcm_torch.nn.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    num_classes: int = 527
    mlp_ratio: float = 4.0
    # audio frontend (model_configs/HTSAT-*.json audio_cfg)
    sample_rate: int = 48000
    mel_bins: int = 64
    window_size_stft: int = 1024
    hop_size: int = 480
    fmin: float = 50.0
    fmax: float = 14000.0
    enable_fusion: bool = False
    fusion_type: str = "None"

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


def htsat_preset(name: str, **overrides) -> HTSATConfig:
    """create_htsat_model presets (htsat.py:981-1028)."""
    presets = {
        "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2)),
        "base": dict(embed_dim=128, depths=(2, 2, 12, 2)),
        "large": dict(embed_dim=256, depths=(2, 2, 12, 2)),
    }
    if name not in presets:
        raise ValueError(f"model name for HTS-AT is wrong: {name}")
    return HTSATConfig(**{**presets[name], **overrides})


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C) (htsat.py:249-260)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    """Pairwise relative position lookup (htsat.py:305-316)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA mask, 0 / -100 (htsat.py:414-433): (nW, ws*ws, ws*ws)."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, args: tuple, device: torch.device) -> torch.Tensor:
    """The relative position index ("index", (ws,)) or a shift mask ("mask",
    (h, w, ws, shift)) on `device`, built once per shape and device, outside
    inference mode (as `t5_encoder.bucket_table`)."""
    table = _relative_position_index(*args) if kind == "index" else _shift_attn_mask(*args)
    with torch.inference_mode(False):
        return torch.from_numpy(table.reshape(-1) if kind == "index" else table).to(device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B*nW, n, C); mask (nW, n, n) or None. The relative position
        bias and the shift mask join the logits; with a mask the windows
        are split (B, nW) so that it broadcasts over B."""
        nh = self.num_heads
        b_, n, c = x.shape
        hd = c // nh
        qkv = self.qkv(x).reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        idx = _on_device("index", (self.window_size,), x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, nh).permute(2, 0, 1)
        if mask is not None:
            bias = bias + mask[:, None]
            qkv = qkv.reshape(3, b_ // mask.shape[0], mask.shape[0], nh, n, hd)
        out = dot_product_attention(qkv[0] * hd**-0.5, qkv[1], qkv[2], 1.0, bias)
        return self.proj(out.reshape(b_, nh, n, hd).transpose(1, 2).reshape(b_, n, c))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """SwinTransformerBlock (htsat.py:364-480). Below the window size the
    window shrinks to the resolution and the shift is off (:393-396)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int, shift_size: int, mlp_ratio: float):
        super().__init__()
        h, w = input_resolution
        if min(h, w) <= window_size:
            window_size, shift_size = min(h, w), 0
        self.input_resolution = input_resolution
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        ws, shift = self.window_size, self.shift_size
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        mask = None
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
            mask = _on_device("mask", (h, w, ws, shift), x.device)
        y = _window_reverse(self.attn(_window_partition(y, ws), mask), ws, h, w)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class _BasicLayer(nn.Module):
    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


def bicubic_align_corners_1d(x: torch.Tensor, out_len: int, dim: int) -> torch.Tensor:
    """torch's bicubic interpolation with align_corners=True (cubic kernel
    A = -0.75, indices clamped at the edges) along one dim of x, as the
    reference resizes the mel (`F.interpolate` over (T, F) with one side
    kept)."""
    if x.shape[dim] == out_len:
        return x
    y = x.movedim(dim, -1)
    rows = y.reshape(1, 1, -1, y.shape[-1])
    out = F.interpolate(rows, size=(rows.shape[2], out_len), mode="bicubic", align_corners=True)
    return out.reshape(*y.shape[:-1], out_len).movedim(-1, dim)


class PatchEmbed(nn.Module):
    """The patch conv and LayerNorm, with the 2D fusion branch
    (htsat.py:71-144): the 3 local mel images go through `mel_conv2d` (3x
    the time stride), side by side in time, padded or cut to the global
    patch width, and fused into the global patches of "longer" clips."""

    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        ps, st = cfg.patch_size, cfg.patch_stride
        pad = (ps - st[0]) // 2
        self.proj = nn.Conv2d(1, cfg.embed_dim, ps, stride=st, padding=pad)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.fusion_2d = cfg.enable_fusion and cfg.fusion_type in ("daf_2d", "aff_2d", "iaff_2d")
        if self.fusion_2d:
            self.mel_conv2d = nn.Conv2d(1, cfg.embed_dim, (ps, ps * 3),
                                        stride=(st[0], st[1] * 3), padding=pad)
            self.fusion_model = fusion_module(cfg.fusion_type, cfg.embed_dim)

    def forward(self, x: torch.Tensor, longer: Optional[torch.Tensor],
                local_mels: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, 1, S, S), local_mels (B, 3, S, S) or None -> (B, L, E)."""
        h = self.proj(x)
        if self.fusion_2d and local_mels is not None:
            b, nc, th, tw = local_mels.shape
            loc = self.mel_conv2d(local_mels.reshape(b * nc, 1, th, tw))
            e, hp, wp = loc.shape[1:]
            loc = loc.reshape(b, nc, e, hp, wp).permute(0, 2, 3, 1, 4).reshape(b, e, hp, nc * wp)
            gw = h.shape[3]
            loc = F.pad(loc, (0, gw - loc.shape[3])) if loc.shape[3] < gw else loc[..., :gw]
            fused = self.fusion_model(h, loc)
            h = torch.where(longer[:, None, None, None], fused, h)
        return self.norm(h.flatten(2).transpose(1, 2))


def bn_over_mel(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """bn0 over the last (mel) axis of a 4D (B, C, T, F) tensor."""
    return bn_eval(bn, x.transpose(1, 3)).transpose(1, 3)


def local_fusion_1d(mod: nn.Module, mel_all: torch.Tensor, mel: torch.Tensor,
                    longer: torch.Tensor) -> torch.Tensor:
    """The 1D fusion of HTSAT (htsat.py:903-923) and PANN: `mod.mel_conv1d`
    over time (stride 3) on each of the 3 local mels, their outputs side by
    side in time, padded or cut to T, fused into the global mel (B, T, F)
    where `longer`."""
    b, _, t, f = mel_all.shape
    loc = run_eval(mod.mel_conv1d, mel_all[:, 1:].reshape(b * 3, t, f).transpose(1, 2))
    tp = loc.shape[2]
    loc = loc.reshape(b, 3, f, tp).permute(0, 2, 1, 3).reshape(b, f, 3 * tp)
    loc = F.pad(loc, (0, max(t - 3 * tp, 0)))[..., :t]
    mel_cf = mel.transpose(1, 2)
    fused = mod.fusion_model(mel_cf, loc)
    return torch.where(longer[:, None, None], fused, mel_cf).transpose(1, 2)


class HTSAT(nn.Module):
    """A waveform batch (B, samples), or with enable_fusion a mel_fusion
    stack (B, 4, T, mel) and its `longer` flags (B,) -> {"embedding" (B, C),
    "clipwise_output" (B, classes), "fine_grained_embedding" (B, T', C),
    "framewise_output" (B, T', classes)} (htsat.py:812-817)."""

    def __init__(self, config: HTSATConfig = HTSATConfig()):
        super().__init__()
        cfg = self.config = config
        self.bn0 = nn.BatchNorm2d(cfg.mel_bins)
        self.patch_embed = PatchEmbed(cfg)
        grid = (cfg.spec_size // cfg.patch_stride[0], cfg.spec_size // cfg.patch_stride[1])
        layers = []
        for i, depth in enumerate(cfg.depths):
            dim = int(cfg.embed_dim * 2**i)
            res = (grid[0] // 2**i, grid[1] // 2**i)
            blocks = [SwinBlock(dim, res, cfg.num_heads[i], cfg.window_size,
                                0 if j % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio)
                      for j in range(depth)]
            last = i == len(cfg.depths) - 1
            layers.append(_BasicLayer(blocks, None if last else PatchMerging(res, dim)))
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(cfg.num_features, eps=1e-5)
        down = 2 ** (len(cfg.depths) - 1)
        cfb = cfg.spec_size // down // cfg.patch_stride[0] // cfg.freq_ratio
        self.tscam_conv = nn.Conv2d(cfg.num_features, cfg.num_classes, (cfb, 3), padding=(0, 1))
        self.fusion_1d = cfg.enable_fusion and cfg.fusion_type in ("daf_1d", "aff_1d", "iaff_1d")
        if self.fusion_1d:
            self.mel_conv1d = nn.Sequential(nn.Conv1d(64, 64, 5, stride=3, padding=2),
                                            nn.BatchNorm1d(64))
            self.fusion_model = fusion_module(cfg.fusion_type, 64)

    def _reshape_wav2img(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) mel -> (B, S, S) image by the freq-ratio tiling
        (htsat.py:833-848)."""
        cfg = self.config
        b = x.shape[0]
        target_t, target_f = cfg.spec_size * cfg.freq_ratio, cfg.spec_size // cfg.freq_ratio
        if x.shape[1] > target_t or x.shape[2] > target_f:
            raise ValueError("mel larger than the swin input lattice")
        x = bicubic_align_corners_1d(x, target_t, dim=1)
        x = bicubic_align_corners_1d(x, target_f, dim=2)
        x = x.transpose(1, 2)  # (B, F, T)
        x = x.reshape(b, x.shape[1], cfg.freq_ratio, x.shape[2] // cfg.freq_ratio)
        return x.permute(0, 2, 1, 3).reshape(b, -1, x.shape[3])

    def forward(self, waveform: Optional[torch.Tensor] = None,
                mel_fusion: Optional[torch.Tensor] = None,
                longer: Optional[torch.Tensor] = None) -> dict:
        cfg = self.config
        if mel_fusion is not None:
            mel_all = bn_over_mel(self.bn0, mel_fusion)  # (B, 4, T, mel), host-prepared
            mel = mel_all[:, 0]
        else:
            acfg = ClapAudioConfig(sample_rate=cfg.sample_rate, window_size=cfg.window_size_stft,
                                   hop_size=cfg.hop_size, mel_bins=cfg.mel_bins, fmin=cfg.fmin,
                                   fmax=cfg.fmax)
            mel = bn_over_mel(self.bn0, logmel_torchlibrosa(waveform, acfg)[:, None])[:, 0]
            mel_all = None

        local_mels = None
        if cfg.enable_fusion and mel_all is not None:
            if self.fusion_1d:
                mel = local_fusion_1d(self, mel_all, mel, longer)
            else:  # the 2D fusion runs inside patch_embed on the images
                b, nc, t, f = mel_all[:, 1:].shape
                local_mels = self._reshape_wav2img(mel_all[:, 1:].reshape(b * nc, t, f)).reshape(
                    b, nc, cfg.spec_size, cfg.spec_size)

        x = self.patch_embed(self._reshape_wav2img(mel)[:, None], longer, local_mels)
        for layer in self.layers:
            for block in layer.blocks:
                x = block(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        x = self.norm(x)

        # the token-semantic head (htsat.py:786-817)
        b, n, c = x.shape
        down = 2 ** (len(cfg.depths) - 1)
        sf = cfg.spec_size // down // cfg.patch_stride[0]
        st = cfg.spec_size // down // cfg.patch_stride[1]
        cfb = sf // cfg.freq_ratio
        img = x.transpose(1, 2).reshape(b, c, sf // cfb, cfb, st)
        img = img.permute(0, 1, 3, 2, 4).reshape(b, c, cfb, -1)  # (B, C, cfb, T')
        ratio = 8 * cfg.patch_stride[1]
        fine = img.mean(dim=2).transpose(1, 2).repeat_interleave(ratio, dim=1)
        embedding = img.reshape(b, c, -1).mean(dim=-1)
        logits = self.tscam_conv(img)[:, :, 0].transpose(1, 2)  # (B, T', classes)
        return {
            "embedding": embedding,
            "clipwise_output": torch.sigmoid(logits.mean(dim=1)),
            "fine_grained_embedding": fine,
            "framewise_output": torch.sigmoid(logits).repeat_interleave(ratio, dim=1),
        }
