"""The comparison that decides `correct`.

After the window closes, a sample of the requests the window finished,
drawn from the seed with one of the longest among them, is run again
through the plain reference (`benchmark/reference`) on the same ids, draws
and weights, in float32 with TF32 off. For every clip of every sampled
request it reads the relative L2 distance of the program's mel (the VAE's
output) and waveform (the vocoder's) from the reference's. Compared, each
against the cell's limit (`benchmark/workloads/<cell>.json`): the worst
clip's mel distance, and the worst clip's waveform distance. Both separate
the program from the fp8 control by over 3x, and a worst, unlike a mean
over the clips, also catches a fault in a single clip (a silent clip reads
1). A clip that is not finite, or of another shape, reads infinity.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from benchmark.harness.traffic import derive


def pick_sample(records: List[tuple], seed: int, n: int) -> List[tuple]:
    """n of the window's (request, seconds, output) records, drawn from the
    seed: one of the longest mel length first, the rest from the others."""
    rng = random.Random(derive(seed, "sample"))
    longest = max(r[0].mel_len for r in records)
    first = rng.choice([r for r in records if r[0].mel_len == longest])
    rest = [r for r in records if r is not first]
    return [first] + rng.sample(rest, min(n - 1, len(rest)))


def rel_l2_per_clip(got: torch.Tensor, want: torch.Tensor) -> List[float]:
    got = got.to(want.device, torch.float32)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return [float("inf")] * want.shape[0]
    g, w = got.flatten(1).double(), want.flatten(1).double()
    return ((g - w).norm(dim=1) / w.norm(dim=1)).tolist()


def compare(sample: List[tuple], reference) -> Dict[str, float]:
    """The numbers over the sample's clips: the worst clip's mel distance
    and the worst clip's waveform distance; `reference(request)` -> (wav,
    mel) of the plain reference."""
    mel_worst, wav_worst = 0.0, 0.0
    for req, _, (got_wav, got_mel) in sample:
        ref_wav, ref_mel = reference(req)
        mel_worst = max(mel_worst, *rel_l2_per_clip(got_mel, ref_mel))
        wav_worst = max(wav_worst, *rel_l2_per_clip(got_wav, ref_wav))
        del ref_wav, ref_mel
    return {"mel_rel_l2": mel_worst, "wav_rel_l2_worst": wav_worst}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
