"""Test-set TSV dataset (AudioCaps / MusicCaps eval input), read with the
`csv` module.

Reference `ldm/data/tsvdataset.py`: tab-separated rows with a header
(name, dataset, ori_cap, mel_path, caption, audio_path); duplicate names
get `_{n}` suffixes in row order (`add_name_num`); mels are zero-padded or
cropped to spec_crop_len (624). TSVDatasetStruct yields
{'caption': {ori_caption, struct_caption}, 'f_name'} and, with
load_mels=True, 'image'.
"""

from __future__ import annotations

import csv
from typing import List

import numpy as np


def add_name_num(names: List[str]) -> List[str]:
    """Disambiguate repeated audio names: the n-th occurrence of a name
    (from 0) becomes f"{name}_{n}"."""
    counts: dict = {}
    out = []
    for name in names:
        n = counts.get(name, -1) + 1
        counts[name] = n
        out.append(f"{name}_{n}")
    return out


class TSVDatasetStruct:
    def __init__(self, tsv_path: str, spec_crop_len: int = 624, load_mels: bool = False):
        with open(tsv_path, newline="") as f:
            self.rows = list(csv.DictReader(f, delimiter="\t"))
        for row, name in zip(self.rows, add_name_num([r["name"] for r in self.rows])):
            row["name"] = name
        self.spec_crop_len = spec_crop_len
        self.load_mels = load_mels

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict:
        row = self.rows[idx]
        item = {"caption": {"ori_caption": row["ori_cap"], "struct_caption": row["caption"]},
                "f_name": row["name"]}
        if self.load_mels and row.get("mel_path"):
            spec = np.load(row["mel_path"]).astype(np.float32)
            if spec.shape[1] <= self.spec_crop_len:
                spec = np.pad(spec, ((0, 0), (0, self.spec_crop_len - spec.shape[1])))
            item["image"] = spec[:, : self.spec_crop_len]
        return item
