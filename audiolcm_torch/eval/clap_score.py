"""The CLAP score (`audiolcm_tpu/eval/clap_score.py`).

Reference `wav_evaluation/cal_clap_score.py` + `models/CLAPWrapper.py`:
each generated wav resampled 16 kHz -> 44.1 kHz (scipy's resample_poly,
on the host) and repeat-padded or cropped to 5 s; captions embedded by the
BERT CLS vector + projection, wavs by Cnn14 + projection; the score is the
mean cosine of the matched (caption, wav) pairs, in batches of 60. The
ground-truth anchor the reference documents: AudioCaps val 0.479077
(`cal_clap_score.py:21`).
"""

from __future__ import annotations

import csv
from typing import Callable, List, Optional

import numpy as np
import torch

GT_ANCHOR = 0.479077


def prepare_clap_audio(wav_16k: np.ndarray, target_sr: int = 44100, source_sr: int = 16000,
                       duration_s: float = 5.0) -> np.ndarray:
    """Resample, then repeat-pad or crop to the CLAP window."""
    from scipy.signal import resample_poly

    g = np.gcd(source_sr, target_sr)
    wav = resample_poly(wav_16k, target_sr // g, source_sr // g).astype(np.float32)
    target_len = int(duration_s * target_sr)
    if len(wav) >= target_len:
        return wav[:target_len]
    reps = -(-target_len // len(wav))
    return np.tile(wav, reps)[:target_len]


def cosine_diag(text_emb: torch.Tensor, audio_emb: torch.Tensor) -> torch.Tensor:
    """The cosine of each matched (text, audio) row pair."""
    t = text_emb / torch.linalg.vector_norm(text_emb, dim=-1, keepdim=True)
    a = audio_emb / torch.linalg.vector_norm(audio_emb, dim=-1, keepdim=True)
    return torch.sum(t * a, dim=-1)


def clap_score(text_embed_fn: Callable[[List[str]], torch.Tensor],
               audio_embed_fn: Callable[[np.ndarray], torch.Tensor], captions: List[str],
               wavs: List[np.ndarray], batch_size: int = 60) -> float:
    """The mean matched cosine over the set, in batches (`cal_clap_score.py:46-58`);
    text_embed_fn(captions) and audio_embed_fn((B, S) 44.1 kHz numpy) return
    (B, D) embeddings on any device."""
    if len(captions) != len(wavs):
        raise ValueError(f"{len(captions)} captions for {len(wavs)} wavs")
    scores = []
    for i in range(0, len(captions), batch_size):
        batch = np.stack([prepare_clap_audio(w) for w in wavs[i:i + batch_size]])
        t_emb = text_embed_fn(captions[i:i + batch_size])
        a_emb = audio_embed_fn(batch)
        scores.append(cosine_diag(t_emb, a_emb.to(t_emb.device)).double().cpu().numpy())
    return float(np.concatenate(scores).mean())


def add_clap_score_to_csv(csv_path: str, scores: List[float],
                          out_path: Optional[str] = None) -> List[dict]:
    """`cal_clap_score.py:60-70`: a clap_score column appended to a
    comma-separated table (rewritten in place unless out_path)."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        fields = [c for c in reader.fieldnames if c != "clap_score"] + ["clap_score"]
        rows = list(reader)
    if len(rows) != len(scores):
        raise ValueError(f"{len(scores)} scores for {len(rows)} rows")
    for row, s in zip(rows, scores):
        row["clap_score"] = s
    with open(out_path or csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    return rows
