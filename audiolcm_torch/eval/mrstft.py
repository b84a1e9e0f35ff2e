"""Multi-resolution STFT distance, the vocoder's validation metric
(`audiolcm_tpu/eval/mrstft.py`).

Reference: auraloss's MultiResolutionSTFTLoss as the vocoder trainer uses
it (`vocoder/bigvgan/train.py:133,158`): per resolution the spectral
convergence ||S - S^||_F / (||S||_F + eps) plus the mean |log(S + eps) -
log(S^ + eps)|, averaged over the resolutions. S is the port's
`dsp/mel.stft_magnitude` (sqrt(re^2 + im^2 + 1e-9)) after a centred
reflect pad of n_fft // 2 (torch.stft's center=True), with a periodic hann
window of win samples centred in n_fft.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from audiolcm_torch.dsp.mel import hann_window, stft_magnitude

RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def _stft_mag_centered(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    pad = n_fft // 2
    y = F.pad(y, (pad, pad), mode="reflect")
    window = torch.from_numpy(hann_window(win)).to(y.device, y.dtype)
    return stft_magnitude(y, window, n_fft, hop, win)


def mrstft_loss(y: torch.Tensor, y_hat: torch.Tensor,
                resolutions: Sequence[Tuple[int, int, int]] = RESOLUTIONS,
                eps: float = 1e-7) -> torch.Tensor:
    """y, y_hat: (B, T) waveforms -> scalar loss; (n_fft, hop, win) per
    resolution."""
    total = 0.0
    for n_fft, hop, win in resolutions:
        s = _stft_mag_centered(y, n_fft, hop, win)
        s_hat = _stft_mag_centered(y_hat, n_fft, hop, win)
        sc = torch.linalg.vector_norm(s - s_hat) / (torch.linalg.vector_norm(s) + eps)
        log_mag = torch.mean(torch.abs(torch.log(s + eps) - torch.log(s_hat + eps)))
        total = total + sc + log_mag
    return total / len(resolutions)
