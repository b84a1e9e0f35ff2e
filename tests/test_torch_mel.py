"""Port parity: audiolcm_torch.dsp.mel against audiolcm_tpu.dsp.mel in f32
on the CPU (the filterbank, the window, both |STFT| forms, the log-mel in
both log bases) and melprep.wav_to_mel against the JAX package's.

Inputs from numpy seeds. Tolerances: the numpy constants exactly; |STFT|
rtol 1e-5 / atol 1e-4 (rFFT and matmul sums in another order, magnitudes
up to ~30); log-mel atol 1e-4 (log10 of the above, floor 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.data import melprep as t_prep
from audiolcm_torch.dsp import mel as t_mel
from audiolcm_tpu.data import melprep as j_prep
from audiolcm_tpu.dsp import mel as j_mel
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

SMALL = dict(n_fft=64, win_size=48, hop_size=8, n_mels=8)


def _wav(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_constants_match_jax():
    for args in ((16000, 1024, 80, 0.0, 8000.0), (16000, 64, 8, 125.0, 7600.0),
                 (22050, 512, 40, 30.0, 11025.0)):
        np.testing.assert_array_equal(t_mel.mel_filterbank(*args), j_mel.mel_filterbank(*args))
    np.testing.assert_array_equal(t_mel.hann_window(1024), j_mel.hann_window(1024))
    for a, b in zip(t_mel._dft_basis(64), j_mel._dft_basis(64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["stft_magnitude", "stft_magnitude_matmul"])
@pytest.mark.parametrize("win", [64, 48])
def test_stft_magnitude_matches_jax(form, win):
    y = _wav(0, (2, 600))
    window = t_mel.hann_window(win)
    ref = np.asarray(getattr(j_mel, form)(jnp.asarray(y), jnp.asarray(window), 64, 8, win))
    out = getattr(t_mel, form)(torch.from_numpy(y), torch.from_numpy(window), 64, 8, win)
    assert out.shape == ref.shape == (2, 33, 1 + (600 - 64) // 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("log_base", ["10", "e"])
@pytest.mark.parametrize("stft_matmul", [False, True])
def test_log_mel_matches_jax(log_base, stft_matmul):
    cfg = dict(SMALL, log_base=log_base, stft_matmul=stft_matmul, fmin=125.0, fmax=7600.0)
    y = _wav(1, (2, 700), scale=0.6)  # some samples beyond +-1: the clamp
    ref = np.asarray(j_mel.MelSpectrogram(j_mel.MelConfig(**cfg))(jnp.asarray(y)))
    ours = t_mel.MelSpectrogram(t_mel.MelConfig(**cfg), device="cpu")
    out = ours(torch.from_numpy(y))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert ref.shape[-1] == ours.num_frames(700)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(ours(torch.from_numpy(y[0])).numpy(), ref[:1], atol=1e-4)


def test_wav_to_mel_matches_jax():
    """The MelNet constants (16 kHz, 80 mels, n_fft 1024, hop 256) on 1.3 s,
    capped at 1 s = 62 frames."""
    wav = _wav(2, (20800,))
    ref = j_prep.wav_to_mel(wav, max_duration_s=1.0)
    out = t_prep.wav_to_mel(wav, max_duration_s=1.0, device="cpu")
    assert out.shape == ref.shape == (80, 62)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(t_prep.wav_to_mel(wav, device="cpu"), j_prep.wav_to_mel(wav),
                               atol=1e-4)


def test_mel_spectrogram_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        t_mel.MelSpectrogram()
