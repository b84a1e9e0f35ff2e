"""The LAION CLAP's PANN audio towers, Cnn14 / Cnn10 / Cnn6, with feature
fusion (`audiolcm_tpu/models/open_clap/pann.py`).

Reference `ldm/modules/encoders/open_clap/pann_model.py`: ConvBlock (two
3x3 conv + BN + ReLU, pann_model.py:32-76; the MS-CLAP Cnn14's, which
`models/clap_audio.py` holds), ConvBlock5x5 (Cnn6), Cnn14 (64..2048 channels, fc1
2048), Cnn10 (64..1024), Cnn6 (64..512), each returning
{"clipwise_output", "embedding", "fine_grained_embedding"}; the fusion
variants "channel_map" (a 4-channel stem), the 1D mel conv before the stem
and the 2D branch after conv_block1. These are the 48 kHz LAION towers
with the fine-grained head, not the MS-CLAP Cnn14 of
`models/clap_audio.py`. NCHW (B, C, T, mel) with the reference's keys;
inference only (BatchNorms on running statistics, dropout and SpecAugment
omitted); the "longer" clips' fusion is a `where` blend, as in HTSAT.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.clap_audio import (ClapAudioConfig, ConvBlock, bn_eval,
                                              logmel_torchlibrosa)
from audiolcm_torch.models.open_clap.fusion import fusion_module, run_eval
from audiolcm_torch.models.open_clap.htsat import bn_over_mel, local_fusion_1d

PLANS = {"Cnn14": (64, 128, 256, 512, 1024, 2048), "Cnn10": (64, 128, 256, 512, 1024),
         "Cnn6": (64, 128, 256, 512)}


@dataclasses.dataclass(frozen=True)
class PannConfig:
    model_name: str = "Cnn14"  # Cnn14 | Cnn10 | Cnn6
    sample_rate: int = 48000
    window_size: int = 1024
    hop_size: int = 480
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    classes_num: int = 527
    enable_fusion: bool = False
    fusion_type: str = "None"

    @property
    def emb_dim(self) -> int:
        return PLANS[self.model_name][-1]


class ConvBlock5x5(nn.Module):
    """Single 5x5 conv + BN + ReLU (pann_model.py:78-113)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 5, padding=2, bias=False)
        self.bn1 = nn.BatchNorm2d(c_out)

    def forward(self, x: torch.Tensor, pool: int = 2) -> torch.Tensor:
        x = F.relu(bn_eval(self.bn1, self.conv1(x)))
        return F.avg_pool2d(x, pool) if pool > 1 else x


def _pool1d_same(x: torch.Tensor) -> torch.Tensor:
    """max + mean pool, kernel 3, stride 1, padding 1, over time of (B, C, T)
    (pann_model.py:313-316; the mean divides by 3 at the edges too)."""
    return F.max_pool1d(x, 3, 1, 1) + F.avg_pool1d(x, 3, 1, 1)


class PannAudioBranch(nn.Module):
    """A waveform (B, samples), or a mel_fusion stack (B, 4, T, mel) and its
    `longer` flags (B,) -> the output dict (pann_model.py's forwards)."""

    def __init__(self, config: PannConfig = PannConfig()):
        super().__init__()
        cfg = self.config = config
        plan = PLANS[cfg.model_name]
        fusion = cfg.fusion_type if cfg.enable_fusion else "None"
        self.bn0 = nn.BatchNorm2d(cfg.mel_bins)
        block = ConvBlock5x5 if cfg.model_name == "Cnn6" else ConvBlock
        c_in = 4 if fusion == "channel_map" else 1
        for i, c_out in enumerate(plan, start=1):
            setattr(self, f"conv_block{i}", block(c_in, c_out))
            c_in = c_out
        self.fc1 = nn.Linear(plan[-1], cfg.emb_dim)
        self.fc_audioset = nn.Linear(cfg.emb_dim, cfg.classes_num)
        self.fusion_1d = fusion in ("daf_1d", "aff_1d", "iaff_1d")
        self.fusion_2d = fusion in ("daf_2d", "aff_2d", "iaff_2d")
        if self.fusion_1d:
            self.mel_conv1d = nn.Sequential(nn.Conv1d(64, 64, 5, stride=3, padding=2),
                                            nn.BatchNorm1d(64))
        if self.fusion_2d:
            self.mel_conv2d = nn.Sequential(nn.Conv2d(1, 64, 5, stride=(6, 2), padding=2),
                                            nn.BatchNorm2d(64))
        if self.fusion_1d or self.fusion_2d:
            self.fusion_model = fusion_module(fusion, 64)

    def forward(self, waveform: Optional[torch.Tensor] = None,
                mel_fusion: Optional[torch.Tensor] = None,
                longer: Optional[torch.Tensor] = None) -> dict:
        cfg = self.config
        if mel_fusion is not None:
            mel_all = bn_over_mel(self.bn0, mel_fusion)
            mel = mel_all[:, 0]
        else:
            acfg = ClapAudioConfig(sample_rate=cfg.sample_rate, window_size=cfg.window_size,
                                   hop_size=cfg.hop_size, mel_bins=cfg.mel_bins, fmin=cfg.fmin,
                                   fmax=cfg.fmax)
            mel = bn_over_mel(self.bn0, logmel_torchlibrosa(waveform, acfg)[:, None])[:, 0]
            mel_all = None

        if self.fusion_1d and mel_all is not None:
            mel = local_fusion_1d(self, mel_all, mel, longer)
        channel_map = cfg.enable_fusion and cfg.fusion_type == "channel_map"
        x = mel_all if channel_map and mel_all is not None else mel[:, None]

        x = self.conv_block1(x, pool=2)
        if self.fusion_2d and mel_all is not None:
            # the local branch after block 1 (pann_model.py:274-297): the 5x5
            # conv at stride (6, 2) on each local mel, side by side in time
            b, _, t, f = mel_all.shape
            loc = F.relu(run_eval(self.mel_conv2d, mel_all[:, 1:].reshape(b * 3, 1, t, f)))
            c, tp, fp = loc.shape[1:]
            loc = loc.reshape(b, 3, c, tp, fp).permute(0, 2, 1, 3, 4).reshape(b, c, 3 * tp, fp)
            th = x.shape[2]
            loc = F.pad(loc, (0, 0, 0, max(th - loc.shape[2], 0)))[:, :, :th]
            x = torch.where(longer[:, None, None, None], self.fusion_model(x, loc), x)

        plan = PLANS[cfg.model_name]
        for i in range(2, len(plan) + 1):
            pool = 1 if (cfg.model_name == "Cnn14" and i == 6) else 2
            x = getattr(self, f"conv_block{i}")(x, pool=pool)

        x = x.mean(dim=3)  # over mel -> (B, C, T')
        latent = F.relu(self.fc1(_pool1d_same(x).transpose(1, 2)))
        emb = F.relu(self.fc1(torch.amax(x, dim=2) + x.mean(dim=2)))
        return {
            "embedding": emb,
            "clipwise_output": torch.sigmoid(self.fc_audioset(emb)),
            "fine_grained_embedding": latent.repeat_interleave(32, dim=1),
        }
