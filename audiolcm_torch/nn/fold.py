"""Overlap-discard time folding: a batch-1 vocoder stage run as a small
batch (`audiolcm_tpu/nn/fold.py`).

The time axis of a (1, C, T) stage input is cut into `fold` overlapping
segments, (1, C, T) -> (fold, C, T/fold + 2*halo); the stage runs on them
as a batch, and the valid interiors are stitched back. With the halo at
least the stage's receptive field, every kept output sample depends only on
input samples inside its segment, so the result is the unfolded stage's
whatever the padding of each op; the first and last segments are aligned
with the signal's edges, so their boundary padding is the real one.

The port is channels-first, so it folds along the last axis. On the TPU the
fold works around XLA's batch-1 layout; whether it pays on the card is a
measurement (`api.build_pipeline`'s docstring).
"""

from __future__ import annotations

import torch


def fold_time(x: torch.Tensor, fold: int, halo: int) -> torch.Tensor:
    """(1, C, T) -> (fold, C, T/fold + 2*halo) overlapping segments.

    Segment k covers [k*L - halo, (k+1)*L + halo), L = T/fold, except the
    first and last, which are shifted to start and end at the signal's
    edges. Needs `fold_legal(T, fold, halo)`."""
    b, _, t = x.shape
    if b != 1:
        raise ValueError(f"fold_time folds a batch of 1, got batch {b}")
    length = t // fold
    seg = length + 2 * halo
    starts = [min(max(k * length - halo, 0), t - seg) for k in range(fold)]
    return torch.cat([x[..., s:s + seg] for s in starts], dim=0)


def unfold_time(y: torch.Tensor, fold: int, halo: int, length: int) -> torch.Tensor:
    """Inverse of fold_time once the segments were scaled by the stage's
    upsample factor: (fold, C, length + 2*halo) -> (1, C, fold*length),
    each segment's halo dropped (offset 0, halo and 2*halo for the first,
    the interior and the last segment)."""
    offs = [0 if k == 0 else (2 * halo if k == fold - 1 else halo) for k in range(fold)]
    return torch.cat([y[k:k + 1, :, o:o + length] for k, o in enumerate(offs)], dim=-1)


def stage_fold_halo(u: int, k_up: int, kernel_sizes, dilation_sizes) -> int:
    """Receptive-field halo, in stage-input samples, of one BigVGAN stage:
    the transposed conv (k_up, stride u), then the mean of the AMPBlock1
    resblocks. Per sub-unit: act (6 on each side at the 2x grid) + conv(k,
    d) + act + conv(k, 1); sub-units add up, resblocks take the max; the
    upsampling conv spreads k_up more output samples; plus 3 input samples
    of margin, as in the JAX package."""
    act_rf = 6
    rf = max(sum(2 * act_rf + (k - 1) // 2 * (d + 1) for d in dils)
             for k, dils in zip(kernel_sizes, dilation_sizes))
    return -(-(rf + k_up) // u) + 3


def fold_legal(t: int, fold: int, halo: int) -> bool:
    """Whether (t, fold, halo) admits the fold: T divisible by fold and
    both halos inside a segment."""
    return fold >= 2 and t % fold == 0 and 2 * halo <= t // fold
