"""Batched STFT magnitude and log-mel spectrogram in torch.

The reference MelNet pipeline (`ldm/data/preprocess/NAT_mel.py:64-85`, the
hifigan-style `vocoder/bigvgan/meldataset.py:60-85`), as
`audiolcm_tpu/dsp/mel.py` computes it:

    wav -> clamp(+-1) -> reflect-pad (n_fft-hop)/2 each side
        -> STFT (hann, center=False, onesided) -> sqrt(re^2+im^2+1e-9)
        -> slaney mel filterbank matmul -> log10 (or ln) of clamp(x, 1e-5)

The constants (filterbank, window, DFT basis) are built with numpy in
float64 and stored as float32. `MelSpectrogram` holds them on the device
it is given (the card unless told otherwise).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_slaney(f) -> np.ndarray:
    """Slaney-scale Hz -> mel (librosa's default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mels, n_fft//2+1):
    librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) with htk=False and
    norm='slaney' (`NAT_mel.py:54`, `meldataset.py:60-67`)."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_size: int) -> np.ndarray:
    """Periodic hann window (torch.hann_window's default)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """STFT/mel constants. The defaults are the generation pipeline's
    (`ldm/data/preprocess/mel_spec.py:196-211`): 16 kHz, 80 mels,
    n_fft = win = 1024, hop 256, fmin 0, fmax 8000 -> 62.5 frames/s.
    log_base "10" is the generation pipeline's log10, "e" the vocoder
    scripts' natural log (`meldataset.py:38-47`). stft_matmul=True computes
    |STFT| as two DFT matmuls instead of an rFFT."""

    sample_rate: int = 16000
    n_fft: int = 1024
    win_size: int = 1024
    hop_size: int = 256
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    clip_val: float = 1e-5
    log_base: str = "10"
    stft_matmul: bool = False


def _windowed_frames(y: torch.Tensor, window: torch.Tensor, n_fft: int, hop_size: int,
                     win_size: int) -> torch.Tensor:
    """(B, L) -> (B, frames, n_fft) windowed, frame i starting at i*hop."""
    if win_size < n_fft:
        pad = (n_fft - win_size) // 2
        window = F.pad(window, (pad, n_fft - win_size - pad))
    return y.unfold(-1, n_fft, hop_size) * window


def stft_magnitude(y: torch.Tensor, window: torch.Tensor, n_fft: int, hop_size: int,
                   win_size: int) -> torch.Tensor:
    """|STFT|, center=False, onesided: (B, L) -> (B, n_fft//2+1, frames),
    sqrt(re^2 + im^2 + 1e-9) as the reference (`NAT_mel.py:79`)."""
    spec = torch.fft.rfft(_windowed_frames(y, window, n_fft, hop_size, win_size), n=n_fft)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int) -> tuple:
    """Real-DFT bases (n_fft, n_fft//2+1): re = x @ cos, im = x @ sin."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def stft_magnitude_matmul(y: torch.Tensor, window: torch.Tensor, n_fft: int, hop_size: int,
                          win_size: int) -> torch.Tensor:
    """stft_magnitude with the rFFT written as two DFT matmuls, in f32 and
    returned in y's dtype. Unlike the JAX function, the basis is never
    rounded to a narrower input dtype; in f32 the two agree."""
    frames = _windowed_frames(y, window, n_fft, hop_size, win_size).float()
    cos_b, sin_b = (torch.from_numpy(b).to(y.device) for b in _dft_basis(n_fft))
    re, im = frames @ cos_b, frames @ sin_b
    return torch.sqrt(re * re + im * im + 1e-9).to(y.dtype).transpose(1, 2)


class MelSpectrogram:
    """Log-mel transform with its constants on `device` (cuda:0 when None;
    raises without a card unless device="cpu"). Call on (B, L) or (L,)."""

    def __init__(self, config: MelConfig = MelConfig(), device=None):
        from audiolcm_torch.pipeline import resolve_device

        self.config = config
        self.device = resolve_device(device)
        self.mel_basis = torch.from_numpy(mel_filterbank(
            config.sample_rate, config.n_fft, config.n_mels, config.fmin, config.fmax)
        ).to(self.device)
        self.window = torch.from_numpy(hann_window(config.win_size)).to(self.device)

    def __call__(self, y) -> torch.Tensor:
        """wav (B, L) in [-1, 1] -> log-mel (B, n_mels, frames), f32."""
        cfg = self.config
        y = torch.as_tensor(y, device=self.device)
        if y.dim() == 1:
            y = y[None, :]
        y = y.clamp(-1.0, 1.0)
        pad = (cfg.n_fft - cfg.hop_size) // 2
        y = F.pad(y, (pad, pad), mode="reflect")
        stft = stft_magnitude_matmul if cfg.stft_matmul else stft_magnitude
        mag = stft(y, self.window.to(y.dtype), cfg.n_fft, cfg.hop_size, cfg.win_size)
        mel = torch.einsum("mf,bft->bmt", self.mel_basis, mag.float())
        log = torch.log if cfg.log_base == "e" else torch.log10
        return log(mel.clamp_min(cfg.clip_val))

    def num_frames(self, num_samples: int) -> int:
        cfg = self.config
        padded = num_samples + 2 * ((cfg.n_fft - cfg.hop_size) // 2)
        return 1 + (padded - cfg.n_fft) // cfg.hop_size
