"""Text-to-audio generation CLI, with the JAX package's flags.

    python -m audiolcm_torch.cli.txt2audio_for_lcm -b configs/audiolcm.yaml \\
        -r model/000184.ckpt --vocoder-ckpt model/vocoder --prompt_txt prompt.txt
    python -m audiolcm_torch.cli.txt2audio_for_lcm ... --teacher --ddim_steps 100 [--plms]

Reference `scripts/txt2audio_for_lcm.py` (the LCM path) and
`scripts/txt2audio_for_2cap.py` (the teacher path, --teacher or --plms):
the same flags (--ddim_steps, -b/--base, -r/--resume, --vocoder-ckpt,
--test-dataset, --outdir, --scale, --n_samples, --prompt_txt,
--sample_rate), the same output names ({name}_sample_{num}_{idx}.wav in
test-set mode, {prompt-with-dashes}_0.wav otherwise) and the same
tab-separated result.csv (caption, audio_path). Prompts run in device
batches of --batch_size, the last one padded with empty prompts. --device
(cuda:0 by default) picks where the pipeline runs.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--prompt_txt", type=str, default="prompt.txt")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--test-dataset", dest="test_dataset", default="none",
                   help="dataset name (tsv comes from the config), or a "
                        "direct path to a .tsv file")
    p.add_argument("--limit", type=int, default=None,
                   help="generate only the first N test-set rows")
    p.add_argument("--outdir", type=str, default="outputs/txt2audio-samples")
    p.add_argument("--ddim_steps", type=int, default=2)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--teacher", action="store_true", help="use the DDIM teacher path")
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--H", type=int, default=20)
    p.add_argument("--W", type=int, default=312)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-b", "--base", type=str, default="")
    p.add_argument("--vocoder-ckpt", dest="vocoder_ckpt", type=str,
                   default="vocoder/logs/audioset")
    p.add_argument("--bert_path", type=str, default="bert-base-uncased")
    p.add_argument("--t5_path", type=str, default="t5-v1_1-large")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def _gen_batch(pipeline, tokenizers, prompts: List[dict], latent_len: int, seed: int,
               teacher_opts: Optional[dict] = None):
    """prompts: [{'ori_caption', 'struct_caption'}] -> (wav, mel) numpy."""
    clap_ids, t5_ids = tokenizers([p["ori_caption"] for p in prompts],
                                  [p["struct_caption"] for p in prompts])
    gen = torch.Generator(device=pipeline.device).manual_seed(seed)
    if teacher_opts is not None:
        with torch.inference_mode():
            context = pipeline.encode_text_ids(clap_ids, t5_ids)
            uncond = pipeline.encode_text_ids(*tokenizers([""], [""]))
        wav, mel = pipeline.generate_teacher(
            context, uncond, latent_len, num_steps=teacher_opts["steps"],
            guidance_scale=teacher_opts["scale"], use_plms=teacher_opts["plms"], generator=gen)
    else:
        wav, mel = pipeline.generate(clap_ids, t5_ids, latent_len, generator=gen)
    return wav.cpu().numpy(), mel.cpu().numpy()


def _padded(captions: List[dict], batch_size: int) -> List[dict]:
    return captions + [{"ori_caption": "", "struct_caption": ""}] * (batch_size - len(captions))


def write_result_csv(path: str, records: List[dict]) -> None:
    """Tab-separated caption/audio_path table with a header, as pandas'
    to_csv(sep='\\t', index=False) writes it."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(["caption", "audio_path"])
        writer.writerows([r["caption"], r["audio_path"]] for r in records)


def main(argv: Optional[List[str]] = None):
    from audiolcm_torch import api
    from audiolcm_torch import config as cfg_mod
    from audiolcm_torch.data.tsvdataset import TSVDatasetStruct

    opt = parse_args(argv)
    os.makedirs(opt.outdir, exist_ok=True)
    pipeline = api.build_pipeline(opt.base, opt.resume or None, opt.vocoder_ckpt,
                                  num_inference_steps=opt.ddim_steps, guidance_scale=opt.scale,
                                  device=opt.device)
    tokenizers = api.Tokenizers(opt.bert_path, opt.t5_path)
    latent_len = opt.W
    # the teacher path: DDIM/PLMS over the checkpoint's DiT (--ddim_steps 100)
    teacher_opts = ({"steps": opt.ddim_steps, "scale": opt.scale, "plms": opt.plms}
                    if (opt.teacher or opt.plms) else None)

    if opt.test_dataset != "none":
        tds_cfg = cfg_mod.load_yaml(opt.base).get("test_dataset", {}).get("params", {})
        # a direct .tsv path overrides the config
        if opt.test_dataset.endswith(".tsv") and os.path.exists(opt.test_dataset):
            tsv_path = opt.test_dataset
        else:
            tsv_path = tds_cfg.get("tsv_path", "audiocaps_test_16000_struct.tsv")
        ds = TSVDatasetStruct(tsv_path, tds_cfg.get("spec_crop_len", 624))
        n_rows = len(ds) if opt.limit is None else min(opt.limit, len(ds))
        items = [ds[i] for i in range(n_rows)]
        records = []
        for start in range(0, len(items), opt.batch_size):
            chunk = items[start:start + opt.batch_size]
            wavs, _ = _gen_batch(pipeline, tokenizers,
                                 _padded([it["caption"] for it in chunk], opt.batch_size),
                                 latent_len, opt.seed + start, teacher_opts)
            for it, wav in zip(chunk, wavs):
                v_n, num = it["f_name"].rsplit("_", 1)
                for idx in range(opt.n_samples):
                    wav_path = os.path.join(opt.outdir, f"{v_n}_sample_{num}_{idx}.wav")
                    api._write_wav(wav_path, wav, opt.sample_rate)
                    records.append({"caption": it["caption"]["ori_caption"],
                                    "audio_path": wav_path})
        write_result_csv(os.path.join(opt.outdir, "result.csv"), records)
    else:
        with open(opt.prompt_txt) as f:
            prompts = [line.strip() for line in f if line.strip()]
        for start in range(0, len(prompts), opt.batch_size):
            chunk = prompts[start:start + opt.batch_size]
            caps = [{"ori_caption": c, "struct_caption": f"<{c}& all>"} for c in chunk]
            wavs, _ = _gen_batch(pipeline, tokenizers, _padded(caps, opt.batch_size), latent_len,
                                 opt.seed + start, teacher_opts)
            for c, wav in zip(chunk, wavs):
                api._write_wav(os.path.join(opt.outdir, f"{c.replace(' ', '-')}_0.wav"), wav,
                               opt.sample_rate)

    print(f"Your samples are ready and waiting for you here: \n{opt.outdir} \nEnjoy.")


if __name__ == "__main__":
    main()
