from audiolcm_torch.dsp.mel import MelConfig, MelSpectrogram, hann_window, mel_filterbank

__all__ = ["MelConfig", "MelSpectrogram", "hann_window", "mel_filterbank"]
