"""One-command acceptance loop: generate, then the CLAP score and FAD as
one JSON line (`audiolcm_tpu/cli/eval_acceptance.py`).

    python -m audiolcm_torch.cli.eval_acceptance \\
        -b configs/audiolcm.yaml --ckpt model.ckpt --vocoder-ckpt vocoder/ \\
        --tsv audiocaps_test_16000_struct.tsv \\
        [--clap_weights CLAP_weights_2022.pth] [--vggish_ckpt vggish.pth] \\
        [--gt_dir D] [--limit N] [--skip_generate] [--device cpu]

The reference's three scripts in one: generation over the test TSV
(`cli/txt2audio_for_lcm.py`, the same argv), the CLAP score
(`cli/cal_clap_score.py`; null without --clap_weights) and FAD against
--gt_dir or the TSV's existing audio_path wavs (VGGish from --vggish_ckpt,
else the checkpoint-free log-mel-stats embedder). --skip_generate scores
the wavs already in --outdir. Prints ONE JSON line and writes it to
<outdir>/acceptance.json, with the JAX package's keys: clap_score,
clap_gt_anchor (AudioCaps val 0.479077), fad, fad_embedder, n_clips,
outdir, and fad_note when there is no ground truth. Everything runs on
--device, the card unless told otherwise. Real scores need the CLAP and
VGGish weights, which are not in the repository.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", required=True, help="model config yaml")
    p.add_argument("--ckpt", required=True, help="main model checkpoint")
    p.add_argument("--vocoder-ckpt", dest="vocoder_ckpt", required=True)
    p.add_argument("--tsv", required=True, help="test-set TSV (audiocaps_test_..._struct.tsv)")
    p.add_argument("--outdir", default="outputs/acceptance")
    p.add_argument("--limit", type=int, default=None, help="cap the number of test rows")
    p.add_argument("--ddim_steps", type=int, default=2)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--W", type=int, default=312)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bert_path", default="bert-base-uncased")
    p.add_argument("--t5_path", default="t5-v1_1-large")
    p.add_argument("--clap_weights", default=None,
                   help="CLAP_weights_2022.pth; omit to skip the CLAP score")
    p.add_argument("--vggish_ckpt", default=None,
                   help="torchvggish state dict for FAD; omit for log-mel-stats FAD")
    p.add_argument("--gt_dir", default=None,
                   help="ground-truth wav dir for FAD; default: the TSV's audio_path files")
    p.add_argument("--skip_generate", action="store_true",
                   help="reuse an existing outdir/result.csv")
    p.add_argument("--out_json", default=None, help="default: <outdir>/acceptance.json")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def _fad(args, gen_wavs: List, out: dict) -> None:
    from audiolcm_torch.data.manifest import read_tsv
    from audiolcm_torch.eval.fad import (
        fad_score,
        load_wav_dir,
        load_wav_paths,
        make_logmel_stats_embedder,
    )

    if args.gt_dir:
        bg = load_wav_dir(args.gt_dir, args.limit)
    else:
        paths = [r["audio_path"] for r in read_tsv(args.tsv).rows[:args.limit or None]]
        bg = load_wav_paths([p for p in paths if p and os.path.exists(p) and p.endswith(".wav")])
    if not bg:
        out.update(fad=None, fad_embedder=None,
                   fad_note="no ground-truth wavs found (pass --gt_dir)")
        return
    if args.vggish_ckpt:
        from audiolcm_torch.cli.cal_fad_score import vggish_embedder

        embed = vggish_embedder(args.vggish_ckpt, args.device)  # fc2 before its ReLU
        out["fad_embedder"] = "vggish"
    else:
        embed = make_logmel_stats_embedder(args.device)
        out["fad_embedder"] = "logmel_stats"
    out["fad"] = fad_score(embed, gen_wavs, bg)


def main(argv: Optional[List[str]] = None) -> dict:
    from audiolcm_torch.pipeline import resolve_device

    args = parse_args(argv)
    args.device = str(resolve_device(args.device))
    os.makedirs(args.outdir, exist_ok=True)

    if not args.skip_generate:
        from audiolcm_torch.cli.txt2audio_for_lcm import main as generate

        gen_argv = [
            "--test-dataset", args.tsv, "-b", args.base, "-r", args.ckpt,
            "--vocoder-ckpt", args.vocoder_ckpt, "--outdir", args.outdir,
            "--ddim_steps", str(args.ddim_steps), "--scale", str(args.scale),
            "--W", str(args.W), "--batch_size", str(args.batch_size),
            "--seed", str(args.seed), "--bert_path", args.bert_path,
            "--t5_path", args.t5_path, "--device", args.device,
        ]
        if args.limit is not None:
            gen_argv += ["--limit", str(args.limit)]
        generate(gen_argv)

    from audiolcm_torch.data.manifest import read_tsv
    from audiolcm_torch.eval.clap_score import GT_ANCHOR
    from audiolcm_torch.eval.fad import load_wav_paths

    rows = read_tsv(os.path.join(args.outdir, "result.csv")).rows
    captions = [r["caption"] for r in rows]
    gen_wavs = load_wav_paths([r["audio_path"] for r in rows])
    out: dict = {"n_clips": len(gen_wavs), "outdir": args.outdir, "clap_gt_anchor": GT_ANCHOR}

    if args.clap_weights:
        from audiolcm_torch.cli import cal_clap_score
        from audiolcm_torch.eval.clap_score import clap_score

        text_fn, audio_fn = cal_clap_score.build_clap_scorers(args.clap_weights, args.bert_path,
                                                              args.device)
        out["clap_score"] = clap_score(text_fn, audio_fn, captions, gen_wavs)
    else:
        out["clap_score"] = None

    _fad(args, gen_wavs, out)

    path = args.out_json or os.path.join(args.outdir, "acceptance.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
