"""VGGish, the AudioSet embedding tower of the FAD harness
(`audiolcm_tpu/models/vggish.py`).

The reference's FAD (`wav_evaluation/metrics/fad.py:18,39`) imports a
vendored torchvggish that is absent from its repo; this follows Google's
public VGGish definition as torchvggish has it:

  wav 16 kHz mono
  -> frames of 400 samples every 160, no padding; periodic hann;
     |rfft(frame, 512)| (each frame zero-padded at its end)
  -> 64-band HTK mel (125..7500 Hz, the DC row zeroed), log(mel + 0.01)
  -> non-overlapping 96-frame examples (96, 64)
  -> VGG [64, M, 128, M, 256, 256, M, 512, 512, M] 3x3 convs with ReLU
  -> (B, 512, 6, 4) permuted to (B, 6, 4, 512) and flattened (torchvggish's
     transposes, so embeddings.0's rows follow (H, W, C))
  -> fc 4096 -> 4096 -> 128, ReLU after each; FAD takes fc2 before its ReLU
  and the release-time PCA + 8-bit quantisation (`vggish_postprocess`).

State dicts keep torchvggish's keys (`features.{0,3,6,8,11,13}`,
`embeddings.{0,2,4}`), so a torchvggish file loads directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VGGishConfig:
    sample_rate: int = 16000
    stft_window: int = 400  # 25 ms
    stft_hop: int = 160  # 10 ms
    fft_length: int = 512
    mel_bins: int = 64
    fmin: float = 125.0
    fmax: float = 7500.0
    log_offset: float = 0.01
    example_frames: int = 96  # 0.96 s, non-overlapping
    embedding_dim: int = 128


def _hertz_to_mel(f):
    """HTK mel scale: 1127 ln(1 + f / 700)."""
    return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)


def vggish_mel_matrix(cfg: VGGishConfig = VGGishConfig()) -> np.ndarray:
    """(spectrogram bins, mel bins) triangles on the HTK mel scale, band
    edges spaced linearly in mel from fmin to fmax; the DC row zeroed."""
    bins = cfg.fft_length // 2 + 1
    spec_mel = _hertz_to_mel(np.linspace(0.0, cfg.sample_rate / 2.0, bins))
    edges = np.linspace(_hertz_to_mel(cfg.fmin), _hertz_to_mel(cfg.fmax), cfg.mel_bins + 2)
    weights = np.empty((bins, cfg.mel_bins), dtype=np.float64)
    for i in range(cfg.mel_bins):
        lo, center, hi = edges[i:i + 3]
        lower = (spec_mel - lo) / (center - lo)
        upper = (hi - spec_mel) / (hi - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0
    return weights.astype(np.float32)


def vggish_log_mel_examples(wav: torch.Tensor, cfg: VGGishConfig = VGGishConfig()) -> torch.Tensor:
    """wav (B, L) at 16 kHz -> (B, num_examples, 96, 64) log-mel patches."""
    b = wav.shape[0]
    frames = wav.unfold(-1, cfg.stft_window, cfg.stft_hop)  # (B, n_frames, win)
    n = np.arange(cfg.stft_window)
    window = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.stft_window)).astype(np.float32)).to(wav)
    mag = torch.abs(torch.fft.rfft(frames * window, n=cfg.fft_length, dim=-1))
    mel = mag @ torch.from_numpy(vggish_mel_matrix(cfg)).to(wav)  # (B, n_frames, 64)
    logmel = torch.log(mel + cfg.log_offset)
    n_examples = logmel.shape[1] // cfg.example_frames
    logmel = logmel[:, :n_examples * cfg.example_frames]
    return logmel.reshape(b, n_examples, cfg.example_frames, cfg.mel_bins)


class VGGish(nn.Module):
    """Log-mel examples (B, 96, 64) -> embeddings (B, 128)."""

    def __init__(self, config: VGGishConfig = VGGishConfig()):
        super().__init__()
        self.config = config
        layers, c_in = [], 1
        for v in (64, "M", 128, "M", 256, 256, "M", 512, 512, "M"):
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, v, 3, padding=1), nn.ReLU()]
                c_in = v
        self.features = nn.Sequential(*layers)
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 4 * 6, 4096), nn.ReLU(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, config.embedding_dim), nn.ReLU())

    def forward(self, examples: torch.Tensor, include_final_relu: bool = True) -> torch.Tensor:
        x = self.features(examples[:, None])  # (B, 512, 6, 4)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C), as torchvggish
        for layer in list(self.embeddings)[:5]:
            x = layer(x)
        return F.relu(x) if include_final_relu else x

    def embed_waveform(self, wav: torch.Tensor, include_final_relu: bool = False) -> torch.Tensor:
        """wav (B, L) -> (B * num_examples, 128): frontend + tower, by default
        fc2 before its ReLU (FAD's convention, fad.py:53-61)."""
        ex = vggish_log_mel_examples(wav, self.config)
        flat = ex.reshape(-1, self.config.example_frames, self.config.mel_bins)
        return self(flat, include_final_relu=include_final_relu)


def vggish_postprocess(embeddings: torch.Tensor, pca_eigen_vectors: torch.Tensor,
                       pca_means: torch.Tensor, quantize: bool = True) -> torch.Tensor:
    """torchvggish's Postprocessor: PCA, clamp to [-2, 2], and with
    `quantize` map to [0, 255] and round."""
    x = (embeddings - pca_means[None, :]) @ pca_eigen_vectors.T
    x = torch.clamp(x, -2.0, 2.0)
    if quantize:
        x = torch.round((x + 2.0) * (255.0 / 4.0))
    return x


def load_vggish(state_dict: dict, device=None) -> VGGish:
    """A torchvggish state dict -> the tower in eval mode on `device` (the
    CPU unless told otherwise). torchvggish's PCA buffers, when present,
    are not the tower's and are left out."""
    from audiolcm_torch.convert import assign_state_dict

    model = assign_state_dict(VGGish(), state_dict)
    return model.eval().requires_grad_(False).to(device or "cpu")
