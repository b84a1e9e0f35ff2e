"""Offline wav -> mel preprocessing (the dataset-prep CLI).

    python -m audiolcm_torch.data.melprep --tsv_path data.tsv [--out_tsv out.tsv]
        [--mel_dir mels/] [--max_duration 20] [--num_workers N] [--skip_existing]
        [--device cpu]

Reference `ldm/data/preprocess/mel_spec.py`, as `audiolcm_tpu/data/melprep.py`
does it: read a TSV with an audio_path column, drop rows whose wav does not
load, resample to 16 kHz mono, compute the MelNet log-mel (constants of
`mel_spec.py:196-211`), cap the frames at max_duration * 62.5, save
`<name>_mel.npy`, and write the table back with mel_path and duration
columns. Tables are read and written with the `csv` module, in the layout
pandas' `to_csv(sep="\\t", index=False)` gives. Mels are computed on
--device (the card by default); with --num_workers > 1 the rows are sharded
over worker subprocesses, which run on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from audiolcm_torch.dsp.mel import MelConfig, MelSpectrogram

MEL_HPARAMS = MelConfig(sample_rate=16000, n_fft=1024, win_size=1024, hop_size=256, n_mels=80,
                        fmin=0.0, fmax=8000.0)
FRAMES_PER_SEC = 62.5


def load_wav_mono_16k(path: str, target_sr: int = 16000) -> Optional[np.ndarray]:
    """scipy load, mean down-mix and polyphase resample; None if the file
    does not load or is empty."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    try:
        sr, data = wavfile.read(path)
    except Exception:
        return None
    if data.size == 0:
        return None
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data


def wav_to_mel(wav: np.ndarray, melspec: Optional[MelSpectrogram] = None,
               max_duration_s: Optional[float] = None, device=None) -> np.ndarray:
    """(L,) wav -> (80, T) log-mel, frames capped at max_duration * 62.5."""
    melspec = melspec or MelSpectrogram(MEL_HPARAMS, device)
    mel = melspec(torch.from_numpy(np.asarray(wav, np.float32))[None, :])[0].cpu().numpy()
    if max_duration_s is not None:
        mel = mel[:, :int(max_duration_s * FRAMES_PER_SEC)]
    return mel


def _mel_out_path(audio_path: str, mel_dir: Optional[str]) -> str:
    base = os.path.splitext(audio_path)[0]
    if mel_dir:
        base = os.path.join(mel_dir, os.path.basename(base))
    return base + "_mel.npy"


def read_tsv(path: str) -> Tuple[List[str], List[dict]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        return list(reader.fieldnames or []), list(reader)


def write_tsv(path: str, fields: List[str], rows: List[dict]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fields, delimiter="\t", lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def process_rows(rows: List[dict], mel_dir: Optional[str] = None, max_duration_s: float = 20.0,
                 skip_existing: bool = False, device=None) -> List[dict]:
    """One {mel_path, duration, keep} per row, saving the mels.
    skip_existing makes reruns resumable: a row whose .npy already loads is
    not recomputed."""
    melspec = MelSpectrogram(MEL_HPARAMS, device)
    if mel_dir:
        os.makedirs(mel_dir, exist_ok=True)
    out = []
    for row in rows:
        mel_path = _mel_out_path(row["audio_path"], mel_dir)
        if skip_existing and os.path.exists(mel_path):
            try:
                frames = np.load(mel_path, mmap_mode="r").shape[1]
                out.append({"mel_path": mel_path, "duration": frames / FRAMES_PER_SEC,
                            "keep": True})
                continue
            except Exception:
                pass  # a corrupt partial file: computed again below
        wav = load_wav_mono_16k(row["audio_path"])
        if wav is None:
            out.append({"mel_path": None, "duration": 0.0, "keep": False})
            continue
        np.save(mel_path, wav_to_mel(wav, melspec, max_duration_s))
        out.append({"mel_path": mel_path, "duration": len(wav) / MEL_HPARAMS.sample_rate,
                    "keep": True})
    return out


def process_tsv(tsv_path: str, out_tsv: Optional[str] = None, mel_dir: Optional[str] = None,
                max_duration_s: float = 20.0, num_workers: int = 1, skip_existing: bool = False,
                device=None) -> List[dict]:
    """Add mel_path and duration columns, save the mels, drop the rows
    whose wav does not load; write the table to out_tsv (default: in
    place) and return its rows. num_workers > 1 shards the rows over worker
    subprocesses (worker r takes rows r::N, on the CPU); the parent merges
    them in the original order, so the table equals a one-worker run's."""
    fields, rows = read_tsv(tsv_path)
    if num_workers <= 1:
        parts = process_rows(rows, mel_dir, max_duration_s, skip_existing, device)
    else:
        parts = _run_workers(tsv_path, mel_dir, max_duration_s, num_workers, skip_existing,
                             len(rows))
    fields += [f for f in ("mel_path", "duration") if f not in fields]
    kept = [dict(row, mel_path=p["mel_path"], duration=p["duration"])
            for row, p in zip(rows, parts) if p["keep"]]
    write_tsv(out_tsv or tsv_path, fields, kept)
    return kept


def _run_workers(tsv_path: str, mel_dir: Optional[str], max_duration_s: float, num_workers: int,
                 skip_existing: bool, n_rows: int) -> List[dict]:
    import subprocess
    import sys
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(num_workers):
            part = os.path.join(tmp, f"part_{r}.tsv")
            argv = [sys.executable, "-m", "audiolcm_torch.data.melprep", "--tsv_path", tsv_path,
                    "--max_duration", str(max_duration_s), "--num_workers", str(num_workers),
                    "--worker_rank", str(r), "--worker_out", part, "--device", "cpu"]
            if mel_dir:
                argv += ["--mel_dir", mel_dir]
            if skip_existing:
                argv += ["--skip_existing"]
            procs.append((part, subprocess.Popen(argv, env=env)))
        merged = {}
        for part, proc in procs:
            if proc.wait() != 0:
                raise RuntimeError(f"melprep worker failed (rc={proc.returncode})")
            for row in read_tsv(part)[1]:
                keep = row["keep"] == "True"
                merged[int(row["orig_index"])] = {
                    "mel_path": row["mel_path"] if keep else None,
                    "duration": float(row["duration"]), "keep": keep}
    if sorted(merged) != list(range(n_rows)):
        raise RuntimeError("melprep worker shards must cover every row exactly once")
    return [merged[i] for i in range(n_rows)]


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="wav -> mel preprocessing (mel_spec.py parity)")
    p.add_argument("--tsv_path", required=True)
    p.add_argument("--out_tsv", default=None)
    p.add_argument("--mel_dir", default=None)
    p.add_argument("--max_duration", type=float, default=20.0)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--skip_existing", action="store_true",
                   help="resume: reuse .npy files that already load")
    p.add_argument("--device", default=None,
                   help="torch device for the mels (default cuda:0); workers use the CPU")
    # worker mode, set by the parent when it shards
    p.add_argument("--worker_rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--worker_out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.worker_rank is not None:
        rows = read_tsv(args.tsv_path)[1]
        idx = list(range(len(rows)))[args.worker_rank::args.num_workers]
        parts = process_rows([rows[i] for i in idx], args.mel_dir, args.max_duration,
                             args.skip_existing, args.device)
        write_tsv(args.worker_out, ["orig_index", "mel_path", "duration", "keep"],
                  [dict(part, orig_index=i) for i, part in zip(idx, parts)])
        return

    rows = process_tsv(args.tsv_path, args.out_tsv, args.mel_dir, args.max_duration,
                       args.num_workers, args.skip_existing, args.device)
    print(f"processed {len(rows)} rows -> {args.out_tsv or args.tsv_path}")


if __name__ == "__main__":
    main()
