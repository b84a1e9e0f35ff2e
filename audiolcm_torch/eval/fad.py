"""Frechet Audio Distance (`audiolcm_tpu/eval/fad.py`).

Reference `wav_evaluation/metrics/fad.py`: embeddings of a generated and a
background wav set -> (mu, sigma) -> ||mu1 - mu2||^2 + Tr(s1 + s2 -
2 sqrt(s1 s2)), with the eps fallback when sqrtm is not finite
(`:107-161`). The statistics and the distance run on the host in numpy and
scipy in float64; the embedding model is any wav -> embeddings function
(`models/vggish.py`, the CLAP audio tower, or the checkpoint-free
`make_logmel_stats_embedder`, which runs the port's log-mel on `device`).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

import numpy as np
from scipy import linalg


def embedding_statistics(embeddings: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(embeddings, axis=0)
    sigma = np.cov(embeddings, rowvar=False)
    return mu, sigma


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """`fad.py:107-161`: the Frechet distance of two Gaussians."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))  # (scipy >= 1.18 has no `disp`)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component in matrix sqrt")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fad_score(embed_fn: Callable[[np.ndarray], np.ndarray], generated_wavs: Iterable[np.ndarray],
              background_wavs: Iterable[np.ndarray]) -> float:
    """FAD between two wav sets under one embedding function."""
    gen = np.concatenate([np.atleast_2d(embed_fn(w)) for w in generated_wavs])
    bg = np.concatenate([np.atleast_2d(embed_fn(w)) for w in background_wavs])
    mu_g, s_g = embedding_statistics(gen)
    mu_b, s_b = embedding_statistics(bg)
    return frechet_distance(mu_b, s_b, mu_g, s_g)


def load_wav_dir(path: str, limit: int | None = None) -> List[np.ndarray]:
    import glob
    import os

    return load_wav_paths(sorted(glob.glob(os.path.join(path, "*.wav")))[:limit])


def load_wav_paths(paths: Iterable[str]) -> List[np.ndarray]:
    """float32 wavs; int16 files scaled by 1/32768."""
    from scipy.io import wavfile

    wavs = []
    for f in paths:
        _, data = wavfile.read(f)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        wavs.append(np.asarray(data, dtype=np.float32))
    return wavs


def make_logmel_stats_embedder(device=None) -> Callable[[np.ndarray], np.ndarray]:
    """Checkpoint-free FAD embedding: per clip the mean and std over time of
    the generation log-mel's 80 bins (160-d), on `device` (cuda:0 unless
    told otherwise). Far weaker than VGGish, but it needs no weights. Clips
    shorter than n_fft + hop are zero-padded to it."""
    from audiolcm_torch.dsp.mel import MelConfig, MelSpectrogram

    mel = MelSpectrogram(MelConfig(), device=device)
    min_len = mel.config.n_fft + mel.config.hop_size

    def embed(wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, dtype=np.float32).reshape(-1)
        if len(wav) < min_len:
            wav = np.pad(wav, (0, min_len - len(wav)))
        m = mel(wav)[0].cpu().numpy()  # (80, T)
        return np.concatenate([m.mean(axis=1), m.std(axis=1)])[None, :]

    return embed
