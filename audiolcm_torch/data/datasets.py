"""Mel datasets and the duration-bucketed, rank-sharded batch loader
(`audiolcm_tpu/data/datasets.py`).

Reference `ldm/data/joinaudiodataset_anylen.py`,
`joinaudiodataset_struct_sample_anylen.py`, `joinaudiodataset_624.py`:
  * mel .npy loading, a pad-value mel in place of a file that fails to load;
  * caption dropout with probability `drop`;
  * duration-sorted fixed-size batches, sharded `batches[rank::world]`
    across processes (`DDPIndexBatchSampler`), reshuffled per epoch with
    seed + epoch;
  * struct datasets: two-pool mixing (main + other), the other pool's
    struct caption synthesized as f'<{cap}& all>';
  * the fixed-length variant tile-pads to 624 frames (VAE training).

Batches pad to the static bucket lattice (`data/buckets.py`) as the JAX
package's do, so both packages batch the same clips to the same lengths;
`use_bucket_lattice=False` pads to the reference's multiple of 4. The
loader is numpy on the host: a batch is a dict of numpy arrays and lists,
and the trainer moves it to its device. With the same seed, every rank
gets the same batches in the same order as the JAX loader's.

A missing caption field (empty, or a column the manifest lacks) reads as
pandas' NaN does in the JAX package: the struct caption is synthesized, and
a missing ori_cap prints as "nan".
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from audiolcm_torch.data import buckets as B
from audiolcm_torch.data.manifest import load_manifests, ordered_indices, split_dataframe


@dataclasses.dataclass
class SpecSample:
    mel: np.ndarray  # (80, T) log-mel
    ori_caption: str
    struct_caption: str
    name: Optional[str] = None


def _text(v: Optional[str]) -> str:
    return "nan" if v is None else v  # str(float("nan")), as pandas gives it


class SpecDataset:
    """Row-indexed mel + caption dataset over TSV manifests."""

    def __init__(self, split: str, spec_dir_path: str, mel_num: int = 80, drop: float = 0.0,
                 pad_value: float = B.PAD_VALUE, synthesize_struct: bool = False, seed: int = 0):
        self.manifest = split_dataframe(load_manifests(spec_dir_path), split)
        self.split = split
        self.mel_num = mel_num
        self.drop = drop
        self.pad_value = pad_value
        self.synthesize_struct = synthesize_struct
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.manifest)

    def ordered_indices(self) -> Sequence[int]:
        return ordered_indices(self.manifest)

    def __getitem__(self, idx: int) -> SpecSample:
        row, cols = self.manifest.rows[idx], self.manifest.columns
        try:
            mel = np.load(row["mel_path"]).astype(np.float32)
        except Exception:
            mel = np.full((self.mel_num, B.MIN_LEN), self.pad_value, dtype=np.float32)
        if "ori_cap" in cols:
            ori = _text(row["ori_cap"])
        else:
            ori = _text(row["caption"]) if "caption" in cols else ""
        if self.synthesize_struct or "caption" not in cols or row["caption"] is None:
            struct = f"<{ori}& all>"
        else:
            struct = row["caption"]
        if self.drop > 0 and self.rng.uniform() <= self.drop:
            ori, struct = "", ""
        return SpecSample(mel=mel, ori_caption=ori, struct_caption=struct,
                          name=row["name"] if "name" in cols else None)


def _batch(samples: List[SpecSample], mel: np.ndarray) -> dict:
    return {"mel": mel, "ori_caption": [s.ori_caption for s in samples],
            "struct_caption": [s.struct_caption for s in samples],
            "names": [s.name for s in samples]}


def collate_pad(samples: List[SpecSample], pad_value: float = B.PAD_VALUE,
                use_bucket_lattice: bool = True) -> dict:
    """Pad mels to a common length: the bucket lattice entry covering the
    batch's longest, or the reference's multiple-of-4 length."""
    lengths = [s.mel.shape[1] for s in samples]
    size = (B.bucket_for_length(max(lengths)) if use_bucket_lattice
            else B.reference_pad_length(lengths))
    out = np.full((len(samples), samples[0].mel.shape[0], size), pad_value, dtype=np.float32)
    for i, s in enumerate(samples):
        t = min(s.mel.shape[1], size)
        out[i, :, :t] = s.mel[:, :t]
    return _batch(samples, out)


def collate_tile(samples: List[SpecSample], target_len: int = 624) -> dict:
    """Fixed-length tile-pad (VAE training, `joinaudiodataset_624.py:52-74`):
    shorter mels are tiled, longer ones cropped."""
    out = np.empty((len(samples), samples[0].mel.shape[0], target_len), dtype=np.float32)
    for i, s in enumerate(samples):
        t = s.mel.shape[1]
        out[i] = s.mel[:, :target_len] if t >= target_len else \
            np.tile(s.mel, (1, -(-target_len // t)))[:, :target_len]
    return _batch(samples, out)


class BucketedBatchLoader:
    """Duration-sorted fixed-size batches, rank-sharded, epoch-reshuffled
    (`DDPIndexBatchSampler`, `joinaudiodataset_anylen.py:130-208`)."""

    def __init__(self, dataset: SpecDataset, batch_size: int, num_replicas: int = 1,
                 rank: int = 0, shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 use_bucket_lattice: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_replicas, self.rank = num_replicas, rank
        self.shuffle, self.seed = shuffle, seed
        self.use_bucket_lattice = use_bucket_lattice
        self.epoch = 0
        indices = list(dataset.ordered_indices())
        batches = [indices[i:i + batch_size] for i in range(0, len(indices), batch_size)]
        if drop_last and batches and len(batches[-1]) < batch_size:
            batches = batches[:-1]
        if len(batches) > num_replicas:
            batches = batches[rank::num_replicas]
        self._batches = batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self._batches)

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self._batches))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for bi in order:
            yield collate_pad([self.dataset[i] for i in self._batches[bi]],
                              pad_value=self.dataset.pad_value,
                              use_bucket_lattice=self.use_bucket_lattice)


class TwoPoolBatchLoader:
    """Main + other pool mixing (`joinaudiodataset_struct_sample_anylen.py:
    151-222`): after each main-pool batch, one random other-pool batch."""

    def __init__(self, main: BucketedBatchLoader, other: BucketedBatchLoader):
        self.main, self.other = main, other

    def set_epoch(self, epoch: int) -> None:
        self.main.set_epoch(epoch)
        self.other.set_epoch(epoch)

    def __len__(self) -> int:
        return 2 * len(self.main)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.main.seed + self.main.epoch)
        n_other, n_main = len(self.other._batches), len(self.main)
        # distinct other-batch picks per epoch (np.random.choice without
        # replacement); a smaller other pool chains full permutations
        if n_other >= n_main:
            order = rng.choice(n_other, size=n_main, replace=False)
        else:
            reps = -(-n_main // n_other)
            order = np.concatenate([rng.permutation(n_other) for _ in range(reps)])[:n_main]
        for batch, oi in zip(self.main, order):
            yield batch
            yield collate_pad([self.other.dataset[i] for i in self.other._batches[int(oi)]],
                              pad_value=self.other.dataset.pad_value)
