"""Standalone BigVGAN inference, with the JAX package's flags.

    python -m audiolcm_torch.cli.vocoder_infer --input_mels_dir mels/ \\
        --checkpoint_file vocoder/ [--output_dir generated_files] [--device cpu]
    python -m audiolcm_torch.cli.vocoder_infer --input_wavs_dir wavs/ \\
        --checkpoint_file g_05000000.pt

Reference `vocoder/bigvgan/inference.py` and `inference_e2e.py`, as
`audiolcm_tpu/cli/vocoder_infer.py` runs them:
  * wav mode (--input_wavs_dir): each wav's mel with the vocoder config's
    STFT constants and the natural log (`meldataset.py:38-60`), vocoded to
    `<stem>_generated.wav`;
  * mel mode (--input_mels_dir): each (num_mels, T) `.npy` vocoded to
    `<stem>_generated_e2e.wav`.
Wavs are int16 scaled by 32768 and clipped to the int16 range (the JAX
package's deliberate deviation from numpy's wraparound).

--checkpoint_file is a reference generator file (config from a sibling
`config.json` or `args.yml`) or a vocoder directory (`best_netG.pt` +
`args.yml`). The vocoder runs with the JAX defaults (no fused stage, f32)
on --device, the card unless told otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

MAX_WAV_VALUE = 32768.0  # meldataset.py:19


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--input_wavs_dir", default=None)
    g.add_argument("--input_mels_dir", default=None)
    p.add_argument("--output_dir", default="generated_files")
    p.add_argument("--checkpoint_file", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def load_generator(checkpoint_file: str, device):
    """(BigVGAN in eval mode on `device`, args dict) from either layout."""
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.convert import (
        assign_state_dict,
        fold_weight_norms,
        load_state_dict,
        load_vocoder_dir,
    )

    if os.path.isdir(checkpoint_file):
        sd, args = load_vocoder_dir(checkpoint_file)
    else:
        sd = load_state_dict(checkpoint_file, key="generator")
        d = os.path.dirname(os.path.abspath(checkpoint_file))
        cfg_json = os.path.join(d, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                args = json.load(f)
        else:
            import yaml

            with open(os.path.join(d, "args.yml")) as f:
                args = yaml.safe_load(f)
    vocoder = assign_state_dict(cfg_mod.build_vocoder_from_args(args), fold_weight_norms(sd))
    return vocoder.to(device).eval().requires_grad_(False), args


def write_int16(path: str, wav: np.ndarray, sample_rate: int) -> None:
    from scipy.io import wavfile

    audio = np.asarray(wav, dtype=np.float32) * MAX_WAV_VALUE
    wavfile.write(path, sample_rate, np.clip(audio, -32768.0, 32767.0).astype(np.int16))
    print(path)


def main(argv: Optional[List[str]] = None) -> None:
    from audiolcm_torch.pipeline import resolve_device

    a = parse_args(argv)
    device = resolve_device(a.device)
    vocoder, h = load_generator(a.checkpoint_file, device)
    os.makedirs(a.output_dir, exist_ok=True)
    sr = int(h.get("sampling_rate", 16000))

    def vocode(mel_btc: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            return vocoder(mel_btc.to(device))[0].cpu().numpy()

    if a.input_wavs_dir is not None:
        from audiolcm_torch.data.melprep import load_wav_mono_16k
        from audiolcm_torch.dsp.mel import MelConfig, MelSpectrogram

        mel_fn = MelSpectrogram(MelConfig(
            sample_rate=sr, n_fft=int(h["n_fft"]), win_size=int(h["win_size"]),
            hop_size=int(h["hop_size"]), n_mels=int(h["num_mels"]), fmin=float(h["fmin"]),
            fmax=float(h["fmax"]), log_base="e"), device)
        for fname in sorted(os.listdir(a.input_wavs_dir)):
            wav = load_wav_mono_16k(os.path.join(a.input_wavs_dir, fname), target_sr=sr)
            if wav is None:
                continue
            mel = mel_fn(torch.from_numpy(wav)[None, :])  # (1, num_mels, T)
            write_int16(os.path.join(a.output_dir, os.path.splitext(fname)[0] + "_generated.wav"),
                        vocode(mel.transpose(1, 2)), sr)
    else:
        for fname in sorted(os.listdir(a.input_mels_dir)):
            if not fname.endswith(".npy"):
                continue
            x = np.load(os.path.join(a.input_mels_dir, fname))
            if x.ndim == 2:  # (num_mels, T) -> (1, num_mels, T)
                x = x[None]
            mel = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1), np.float32))
            write_int16(os.path.join(a.output_dir,
                                     os.path.splitext(fname)[0] + "_generated_e2e.wav"),
                        vocode(mel), sr)


if __name__ == "__main__":
    main()
