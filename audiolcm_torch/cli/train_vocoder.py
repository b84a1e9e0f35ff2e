"""BigVGAN vocoder training (`audiolcm_tpu/cli/train_vocoder.py`).

    python -m audiolcm_torch.cli.train_vocoder --config bigvgan_16k.json \\
        --tsv_path wavs.tsv [--checkpoint_path logs/vocoder] [--device cpu]

Reference `vocoder/bigvgan/train.py`: the JSON config
(`bigvgan_audioset16khz_80band.json` schema) builds the generator and the
MPD/MRD discriminators, and the alternating GAN steps run over random
fixed-size wav segments (segment_size 8192 -> 32 mel frames) from a TSV's
audio_path column, 1000 steps per epoch. The reference's
`train_vocoder.py` imports a missing `audiodataset` module; like the JAX
trainer, this one reads the TSV instead. `build` sets everything up and
`fit` runs it, so a caller can run a few steps; `main` is both.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Iterator, List, Optional

import numpy as np
import torch

STEPS_PER_EPOCH = 1000


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="bigvgan json config")
    p.add_argument("--tsv_path", required=True, help="TSV with an audio_path column")
    p.add_argument("--checkpoint_path", default="logs/vocoder")
    p.add_argument("--training_epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def segment_loader(tsv_path: str, batch_size: int, segment_size: int, seed: int,
                   mel_fn) -> Iterator[dict]:
    """Random fixed-size wav segments and their mels (meldataset.py
    semantics), numpy: {"wav": (B, segment), "mel": (B, frames, mels)}.
    The segments are the JAX loader's for the same seed."""
    from audiolcm_torch.data.melprep import load_wav_mono_16k

    with open(tsv_path, newline="") as f:
        paths = [r["audio_path"] for r in csv.DictReader(f, delimiter="\t")]
    rng = np.random.default_rng(seed)
    wavs = [w for w in map(load_wav_mono_16k, paths) if w is not None and len(w) >= segment_size]
    if not wavs:
        raise ValueError("no usable wavs >= segment_size")
    while True:
        seg = np.stack([
            w[(s := rng.integers(0, len(w) - segment_size + 1)): s + segment_size]
            for w in (wavs[i] for i in rng.integers(0, len(wavs), batch_size))])
        mel = mel_fn(seg).cpu().numpy()  # (B, mels, frames)
        yield {"wav": seg, "mel": mel.transpose(0, 2, 1)}


def build_models(h: dict, device):
    """(generator, MPD, MRD) of a JSON config on `device`, f32, the
    generator unfused."""
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.models.vocoder_discriminators import (
        MRD_RESOLUTIONS,
        MultiPeriodDiscriminator,
        MultiResolutionDiscriminator,
    )

    d_mult = h.get("discriminator_channel_mult", 1)
    gen = cfg_mod.build_vocoder_from_args(h)  # pallas_stage_max_channels=0
    mpd = MultiPeriodDiscriminator(tuple(h.get("mpd_reshapes", (2, 3, 5, 7, 11))), d_mult)
    mrd = MultiResolutionDiscriminator(
        tuple(tuple(r) for r in h.get("resolutions", MRD_RESOLUTIONS)), d_mult)
    return gen.to(device), mpd.to(device), mrd.to(device)


def load_reference_discriminators(mpd, mrd, path: str) -> None:
    """A reference `do_<step>` file ({"mpd": sd, "mrd": sd}, weight-normed
    convs) into the port's plain-conv discriminators."""
    from audiolcm_torch.convert import assign_state_dict, fold_weight_norms

    obj = torch.load(path, map_location="cpu", weights_only=False)
    assign_state_dict(mpd, fold_weight_norms(obj["mpd"]))
    assign_state_dict(mrd, fold_weight_norms(obj["mrd"]))


def build(args, device=None) -> dict:
    """The trainer's pieces: {"trainer", "state", "loader_factory"};
    loader_factory(epoch, n) yields n batches."""
    from audiolcm_torch.dsp.mel import MelConfig, MelSpectrogram
    from audiolcm_torch.parallel.mesh import init_distributed, local_device
    from audiolcm_torch.pipeline import resolve_device
    from audiolcm_torch.train.checkpoints import CheckpointManager
    from audiolcm_torch.train.loop import Trainer
    from audiolcm_torch.train.vocoder_gan import (
        VocoderGANConfig,
        init_vocoder_gan_state,
        make_vocoder_gan_steps,
    )

    device = resolve_device(local_device(device if device is not None else args.device))
    init_distributed(device)
    with open(args.config) as f:
        h = json.load(f)
    torch.manual_seed(args.seed)
    gen, mpd, mrd = build_models(h, device)
    mel_kw = dict(sample_rate=h["sampling_rate"], n_fft=h["n_fft"], win_size=h["win_size"],
                  hop_size=h["hop_size"], n_mels=h["num_mels"], fmin=h["fmin"])
    melspec = MelSpectrogram(MelConfig(**mel_kw, fmax=h["fmax"]), device=device)
    # the loss's mel uses fmax_for_loss (None -> the full band), train.py semantics
    loss_mel = MelSpectrogram(MelConfig(**mel_kw, fmax=h.get("fmax_for_loss")
                                        or h["sampling_rate"] / 2), device=device)
    segment_size = h.get("segment_size", 8192)
    vcfg = VocoderGANConfig(learning_rate=h.get("learning_rate", 1e-4),
                            adam_b1=h.get("adam_b1", 0.8), adam_b2=h.get("adam_b2", 0.99),
                            lr_decay=h.get("lr_decay", 0.999), segment_size=segment_size,
                            steps_per_epoch=STEPS_PER_EPOCH)
    disc_step, gen_step = make_vocoder_gan_steps(vcfg, loss_mel)
    state = init_vocoder_gan_state(gen, mpd, mrd, vcfg)
    hop = h["hop_size"]

    def step_fn(state, batch, generator=None):
        mel = torch.as_tensor(batch["mel"], device=device)
        wav = torch.as_tensor(batch["wav"], device=device)[:, : mel.shape[1] * hop]
        state, dm = disc_step(state, mel, wav)
        state, gm = gen_step(state, mel, wav)
        return state, {**dm, **gm}

    loader = segment_loader(args.tsv_path, h.get("batch_size", 32), segment_size, args.seed,
                            melspec)
    ckpt = CheckpointManager(os.path.join(args.checkpoint_path, "checkpoints"))
    trainer = Trainer(step_fn, state, args.checkpoint_path, checkpoints=ckpt)
    return {"trainer": trainer, "state": state,
            "loader_factory": lambda epoch, n=STEPS_PER_EPOCH: (next(loader) for _ in range(n))}


def fit(built: dict, epochs: int, steps_per_epoch: int = STEPS_PER_EPOCH) -> None:
    """Train `epochs` epochs of `steps_per_epoch` steps (the schedule's
    epoch stays STEPS_PER_EPOCH updates)."""
    built["trainer"].fit(lambda e: built["loader_factory"](e, steps_per_epoch), epochs)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    fit(build(args), args.training_epochs)


if __name__ == "__main__":
    main()
