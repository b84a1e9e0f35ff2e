"""The CLAP audio tower, Cnn14 (PANN), for the CLAP score
(`audiolcm_tpu/models/clap_audio.py`).

Reference `wav_evaluation/models/audio.py` (`ldm/modules/encoders/CLAP/
audio.py`): 44.1 kHz mono wav -> torchlibrosa's power spectrogram (hann,
center=True reflect pad, win = n_fft = 1024, hop 320) -> 64 slaney mels
(50..14000 Hz), 10 log10(max(mel, 1e-10)) -> bn0 over the mel axis -> six
ConvBlocks (2 x conv3x3-BN-ReLU, then a 2x2 average pool that floors odd
sizes on time and mel; the last block does not pool) -> the mean over mel,
then max + mean over time -> fc1 with ReLU -> 2048-d; then the contrastive
Projection to 1024 (`CLAP/clap.py:22-40`). The power is the square of the
port's `stft_magnitude`, so re^2 + im^2 + 1e-9. The BatchNorms are
eval-only (eps 1e-5, the checkpoint's running statistics): this tower only
scores. NCHW (B, 1, T, mel).

State dicts keep PANN's keys (`bn0`, `conv_block{i}.conv{j}`,
`conv_block{i}.bn{j}`, `fc1`); a reference file's other entries (the STFT
and mel buffers, `fc_audioset`) are not the tower's.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.dsp.mel import hann_window, mel_filterbank, stft_magnitude
from audiolcm_torch.models.clap_text import Projection

WIDTHS = (64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class ClapAudioConfig:
    sample_rate: int = 44100
    window_size: int = 1024
    hop_size: int = 320
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    out_emb: int = 2048
    classes_num: int = 527
    amin: float = 1e-10


def logmel_torchlibrosa(wav: torch.Tensor, cfg: ClapAudioConfig) -> torch.Tensor:
    """torchlibrosa's Spectrogram + LogmelFilterBank: (B, L) -> (B, T, mel)."""
    pad = cfg.window_size // 2
    y = F.pad(wav, (pad, pad), mode="reflect")
    window = torch.from_numpy(hann_window(cfg.window_size)).to(wav)
    power = stft_magnitude(y, window, cfg.window_size, cfg.hop_size, cfg.window_size) ** 2
    mel_w = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.window_size, cfg.mel_bins,
                                            cfg.fmin, cfg.fmax)).to(wav)
    mel = torch.einsum("mf,bft->btm", mel_w, power)
    return 10.0 * torch.log10(torch.clamp_min(mel, cfg.amin))


def _bn_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c_out)
        self.bn2 = nn.BatchNorm2d(c_out)

    def forward(self, x: torch.Tensor, pool: int = 2) -> torch.Tensor:
        x = F.relu(_bn_eval(self.bn1, self.conv1(x)))
        x = F.relu(_bn_eval(self.bn2, self.conv2(x)))
        return F.avg_pool2d(x, pool) if pool > 1 else x


class Cnn14(nn.Module):
    """wav (B, L) at 44.1 kHz -> embedding (B, out_emb)."""

    def __init__(self, config: ClapAudioConfig = ClapAudioConfig()):
        super().__init__()
        self.config = config
        self.bn0 = nn.BatchNorm2d(config.mel_bins)
        for i, (c_in, c_out) in enumerate(zip((1,) + WIDTHS[:-1], WIDTHS)):
            setattr(self, f"conv_block{i + 1}", ConvBlock(c_in, c_out))
        self.fc1 = nn.Linear(WIDTHS[-1], config.out_emb)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = logmel_torchlibrosa(wav, self.config)[:, None]  # (B, 1, T, mel)
        x = _bn_eval(self.bn0, x.transpose(1, 3)).transpose(1, 3)  # bn0 over the mel axis
        for i in range(len(WIDTHS)):
            x = getattr(self, f"conv_block{i + 1}")(x, pool=2 if i < len(WIDTHS) - 1 else 1)
        x = torch.mean(x, dim=3)  # over mel -> (B, C, T')
        x = torch.amax(x, dim=2) + torch.mean(x, dim=2)
        return F.relu(self.fc1(x))


class ClapAudioEncoder(nn.Module):
    """Cnn14 (`base`) + the contrastive projection (`projection`) to the
    shared 1024-d space."""

    def __init__(self, config: ClapAudioConfig = ClapAudioConfig(), d_proj: int = 1024):
        super().__init__()
        self.base = Cnn14(config)
        self.projection = Projection(config.out_emb, d_proj)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.projection(self.base(wav))
