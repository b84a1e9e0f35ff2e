"""VAE round trip: mel -> latent -> mel -> BigVGAN wav, with the JAX
package's flags.

    python -m audiolcm_torch.cli.reconstruct_audio -b configs/autoencoder1d.yaml \\
        -r vae.ckpt --vocoder-ckpt vocoder/ [--outdir ...] [--batch_size 8] \\
        [--save_mel] [--device cpu]

Reference `scripts/reconstruct_audio.py`, as
`audiolcm_tpu/cli/reconstruct_audio.py` runs it: the config's test_dataset
TSV in batches, each mel through the VAE with a sampled posterior, the
reconstruction vocoded; `<name>.wav` (and `<name>.npy`, the (num_mels, T)
reconstruction, with --save_mel) per row, and the reconstruction MSE
printed as test/mse_loss (`autoencoder1d.py:115-139`). The VAE comes from
the config's first_stage_config, or is the config's root model
(configs/autoencoder1d.yaml); the vocoder runs with the JAX defaults (no
fused stage). Everything is f32 on --device, the card unless told
otherwise. Batch b draws its posterior sample from a torch.Generator
seeded with its first row's index.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", type=str, required=True)
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("--vocoder-ckpt", dest="vocoder_ckpt", type=str, required=True)
    p.add_argument("--outdir", type=str, default="outputs/reconstructions")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--save_mel", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda:0; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


@torch.inference_mode()
def roundtrip(vae, vocoder, mel_btc: torch.Tensor, generator: Optional[torch.Generator]):
    """mel (B, T, num_mels) -> (reconstruction (B, T, num_mels), wav (B, 256*T)):
    encode, sample the posterior from `generator`, decode, vocode."""
    from audiolcm_torch.models.vae1d import DiagonalGaussian

    z = DiagonalGaussian(vae.encode_moments(mel_btc)).sample(generator)
    recon = vae.decode(z)
    return recon, vocoder(recon)


def load_models(base: str, resume: str, vocoder_ckpt: str, device):
    """(vae, vocoder) in eval mode on `device` from the config, the VAE (or
    LDM) checkpoint and the vocoder directory."""
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.cli.vocoder_infer import load_generator
    from audiolcm_torch.convert import assign_state_dict, load_state_dict, strip_prefix

    model_cfg = cfg_mod.load_yaml(base)["model"]
    sd = load_state_dict(resume)
    if "first_stage_config" in (model_cfg.get("params") or {}):
        vae = cfg_mod.build_vae(model_cfg["params"]["first_stage_config"])
        sd = strip_prefix(sd, "first_stage_model.")
    else:
        vae = cfg_mod.build_vae(model_cfg)
    vae = assign_state_dict(vae, sd).to(device).eval().requires_grad_(False)
    return vae, load_generator(vocoder_ckpt, device)[0]


def main(argv: Optional[List[str]] = None) -> None:
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.api import _write_wav
    from audiolcm_torch.data.tsvdataset import TSVDatasetStruct
    from audiolcm_torch.pipeline import resolve_device

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    os.makedirs(opt.outdir, exist_ok=True)
    vae, vocoder = load_models(opt.base, opt.resume, opt.vocoder_ckpt, device)
    tds_cfg = cfg_mod.load_yaml(opt.base).get("test_dataset", {}).get("params", {})
    ds = TSVDatasetStruct(tds_cfg["tsv_path"], tds_cfg.get("spec_crop_len", 624), load_mels=True)
    mses = []
    for start in range(0, len(ds), opt.batch_size):
        items = [ds[i] for i in range(start, min(start + opt.batch_size, len(ds)))]
        mel = np.stack([it["image"] for it in items])  # (B, num_mels, T)
        mel_btc = torch.from_numpy(mel.transpose(0, 2, 1).copy()).to(device)
        recon, wav = roundtrip(vae, vocoder, mel_btc,
                               torch.Generator(device).manual_seed(start))
        recon = recon.cpu().numpy().transpose(0, 2, 1)
        mses.append(np.mean((recon - mel) ** 2))
        for it, w, r in zip(items, wav.cpu().numpy(), recon):
            _write_wav(os.path.join(opt.outdir, f"{it['f_name']}.wav"), w, opt.sample_rate)
            if opt.save_mel:
                np.save(os.path.join(opt.outdir, f"{it['f_name']}.npy"), r)
    print(f"test/mse_loss: {float(np.mean(mses)):.6f}")
    print(f"reconstructions written to {opt.outdir}")


if __name__ == "__main__":
    main()
