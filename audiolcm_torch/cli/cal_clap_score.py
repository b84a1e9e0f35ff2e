"""CLAP-score CLI (`audiolcm_tpu/cli/cal_clap_score.py`; the reference's
`wav_evaluation/cal_clap_score.py`).

    python -m audiolcm_torch.cli.cal_clap_score --tsv_path outdir/result.csv \\
        --clap_weights CLAP_weights_2022.pth [--bert_path D] [--device cpu]

Reads a tab-separated result.csv (caption and audio_path columns, as
`cli/txt2audio_for_lcm.py` writes it), embeds the captions with the
CLAP-BERT CLS tower and the wavs with Cnn14, and prints the mean matched
cosine, in batches of 60. Needs the MS-CLAP weights file (its `model` key)
and a local bert tokenizer directory; neither is in the repository. Runs
on --device, the card unless told otherwise.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv_path", required=True, help="result.csv (tab-separated)")
    p.add_argument("--clap_weights", required=True, help="CLAP_weights_2022.pth")
    p.add_argument("--bert_path", default="bert-base-uncased")
    p.add_argument("--batch_size", type=int, default=60)
    p.add_argument("--out_csv", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


class ClapTokenizer:
    """The bert tokenizer of a local directory: captions -> (B, 77) ids."""

    def __init__(self, bert_path: str, max_length: int = 77):
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(bert_path)
        self.max_length = max_length

    def __call__(self, captions: List[str]) -> torch.Tensor:
        ids = self.tokenizer(list(captions), truncation=True, max_length=self.max_length,
                             padding="max_length", return_tensors="np")["input_ids"]
        return torch.from_numpy(ids)


def build_clap_scorers(clap_weights: str, bert_path: str, device=None, **clap_kw):
    """(text_embed_fn, audio_embed_fn) over the CLAP file's `model` state
    dict on `device` (cuda:0 unless told otherwise): captions -> (B, 1024)
    projected CLS vectors, and (B, S) 44.1 kHz numpy wavs -> (B, 1024)
    projected Cnn14 embeddings. clap_kw (text_config, audio_config,
    d_proj) builds another `models/clap.CLAP` than the reference file's.
    The tokenizer (`ClapTokenizer`) is loaded at the first caption batch."""
    from audiolcm_torch.convert import assign_state_dict, load_state_dict
    from audiolcm_torch.models.clap import CLAP
    from audiolcm_torch.pipeline import resolve_device

    device = resolve_device(device)
    model = assign_state_dict(CLAP(**clap_kw), load_state_dict(clap_weights, key="model"))
    model = model.eval().requires_grad_(False).to(device)
    tokenizer = []

    @torch.inference_mode()
    def text_embed_fn(captions: List[str]) -> torch.Tensor:
        if not tokenizer:
            tokenizer.append(ClapTokenizer(bert_path))
        return model.embed_text(tokenizer[0](captions).to(device))

    @torch.inference_mode()
    def audio_embed_fn(wavs: np.ndarray) -> torch.Tensor:
        return model.audio_encoder(torch.as_tensor(wavs, dtype=torch.float32, device=device))

    return text_embed_fn, audio_embed_fn


def main(argv: Optional[List[str]] = None) -> float:
    from audiolcm_torch.data.manifest import read_tsv
    from audiolcm_torch.eval.clap_score import clap_score
    from audiolcm_torch.eval.fad import load_wav_paths

    args = parse_args(argv)
    table = read_tsv(args.tsv_path)
    captions = [r["caption"] for r in table.rows]
    wavs = load_wav_paths([r["audio_path"] for r in table.rows])
    text_fn, audio_fn = build_clap_scorers(args.clap_weights, args.bert_path, args.device)
    score = clap_score(text_fn, audio_fn, captions, wavs, args.batch_size)
    print(f"mean clap score: {score:.6f}")
    if args.out_csv:
        import csv

        with open(args.out_csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=table.columns + ["clap_score_mean"],
                                    delimiter="\t", lineterminator="\n")
            writer.writeheader()
            writer.writerows({**r, "clap_score_mean": score} for r in table.rows)
    return score


if __name__ == "__main__":
    main()
