"""FAD CLI (`audiolcm_tpu/cli/cal_fad_score.py`; the reference's
`wav_evaluation/cal_fad_score.py`).

    python -m audiolcm_torch.cli.cal_fad_score --generated_dir G \\
        --background_dir B (--vggish_ckpt F | --clap_weights F | --use_vggish) \\
        [--limit N] [--device cpu]

The Frechet Audio Distance between two directories of wavs under one
embedding model:
  --vggish_ckpt  the port's VGGish (models/vggish.py) from a torchvggish
                 state dict, fc2 before its ReLU;
  --clap_weights the CLAP file's Cnn14 + projection on 5 s at 44.1 kHz;
  --use_vggish   torchvggish from torch hub, which needs the network (as in
                 the JAX package; no test or smoke run takes this path).
The models run on --device, the card unless told otherwise; the
statistics in numpy.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--generated_dir", required=True)
    p.add_argument("--background_dir", required=True)
    p.add_argument("--vggish_ckpt", default=None,
                   help="torchvggish-layout state dict for the port's VGGish tower")
    p.add_argument("--clap_weights", default=None,
                   help="CLAP_weights_2022.pth (Cnn14 embedding model)")
    p.add_argument("--use_vggish", action="store_true", help="torch-hub VGGish (needs network)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def vggish_embedder(vggish_ckpt: str, device):
    """wav (L,) -> (num_examples, 128) pre-activation VGGish embeddings."""
    from audiolcm_torch.convert import load_state_dict
    from audiolcm_torch.models.vggish import load_vggish

    model = load_vggish(load_state_dict(vggish_ckpt), device)

    @torch.inference_mode()
    def embed(wav: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(wav, dtype=torch.float32, device=device)[None, :]
        return model.embed_waveform(x).cpu().numpy()

    return embed


def main(argv: Optional[List[str]] = None) -> float:
    from audiolcm_torch.eval.fad import fad_score, load_wav_dir
    from audiolcm_torch.pipeline import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    gen = load_wav_dir(args.generated_dir, args.limit)
    bg = load_wav_dir(args.background_dir, args.limit)
    if args.vggish_ckpt:
        embed_fn = vggish_embedder(args.vggish_ckpt, device)
    elif args.use_vggish:
        model = torch.hub.load("harritaylor/torchvggish", "vggish", device=device)
        model.eval()

        def embed_fn(wav):
            with torch.no_grad():
                return model.forward(wav, 16000).cpu().numpy()
    else:
        if args.clap_weights is None:
            raise SystemExit("pass --vggish_ckpt, --clap_weights or --use_vggish")
        from audiolcm_torch.cli import cal_clap_score
        from audiolcm_torch.eval.clap_score import prepare_clap_audio

        _, audio_fn = cal_clap_score.build_clap_scorers(args.clap_weights, "bert-base-uncased",
                                                        device)

        def embed_fn(wav):
            return audio_fn(prepare_clap_audio(wav)[None, :]).cpu().numpy()

    score = fad_score(embed_fn, gen, bg)
    print(f"FAD: {score:.6f}")
    return score


if __name__ == "__main__":
    main()
