"""TSV manifest loading and split semantics (`audiolcm_tpu/data/manifest.py`),
read with the `csv` module.

Reference `ldm/data/joinaudiodataset_anylen.py:18-66`: glob *.tsv over
comma-separated directories and concatenate; val = the first 100 rows,
train = the rest; test adds a `_{n}` suffix to repeated names
(`add_name_num`); `ordered_indices` sorts by the duration column.

A manifest is a `Manifest`: its columns and its rows as dicts. Fields read
as pandas' `read_csv` reads them where it matters: an empty field (or one
of pandas' default NA strings) is missing (None), and so is a column that
another file of the concatenation lacks; `duration` is a number, int64 when
every value is an integer literal and float64 otherwise, as pandas infers
it. Every other field stays a string.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

# pandas' default na_values (read_csv keep_default_na=True)
NA_STRINGS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                        "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                        "nan", "null"})


@dataclasses.dataclass
class Manifest:
    columns: List[str]
    rows: List[Dict[str, Optional[str]]]

    def __len__(self) -> int:
        return len(self.rows)

    def take(self, start: int = 0, stop: Optional[int] = None) -> "Manifest":
        return Manifest(list(self.columns), self.rows[start:stop])


def read_tsv(path: str) -> Manifest:
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        rows = [{k: (None if v is None or v in NA_STRINGS else v) for k, v in r.items()}
                for r in reader]
        return Manifest(list(reader.fieldnames or []), rows)


def concat(parts: Sequence[Manifest]) -> Manifest:
    """pd.concat(ignore_index=True): the union of the columns in order of
    first appearance, missing fields None."""
    columns: List[str] = []
    for p in parts:
        columns += [c for c in p.columns if c not in columns]
    rows = [{c: r.get(c) for c in columns} for p in parts for r in p.rows]
    return Manifest(columns, rows)


def load_manifests(spec_dir_path: str) -> Manifest:
    files: List[str] = []
    for dir_path in spec_dir_path.split(","):
        files += glob.glob(f"{dir_path}/*.tsv")
    if not files:
        raise FileNotFoundError(f"no .tsv manifests under {spec_dir_path!r}")
    return concat([read_tsv(f) for f in files])


def add_name_num(m: Manifest) -> Manifest:
    """Disambiguate repeated audio names across captions (test split)."""
    counts: dict = {}
    rows = []
    for r in m.rows:
        n = counts.get(r["name"], -1) + 1
        counts[r["name"]] = n
        rows.append({**r, "name": f"{r['name']}_{n}"})
    return Manifest(list(m.columns), rows)


def split_dataframe(m: Manifest, split: str) -> Manifest:
    if split == "train":
        return m.take(100)
    if split in ("valid", "val"):
        return m.take(0, 100)
    if split == "test":
        return add_name_num(m)
    if split == "all":  # no validation carve-out (the struct other-pool)
        return m.take()
    raise ValueError(f"Unknown split {split!r}")


def durations(m: Manifest) -> np.ndarray:
    """The duration column as pandas types it: int64 when every field is an
    integer literal, else float64 (missing -> NaN)."""
    vals = [r.get("duration") for r in m.rows]
    try:
        return np.array([int(v) for v in vals], dtype=np.int64)
    except (TypeError, ValueError):
        return np.array([np.nan if v is None else float(v) for v in vals], dtype=np.float64)


def ordered_indices(m: Manifest) -> List[int]:
    """Duration-sorted row order (keeps pad waste low per batch), in pandas'
    order: `sort_values` argsorts with numpy's quicksort, which is not
    stable, so rows of equal duration come out as numpy's quicksort leaves
    them; missing durations go last."""
    d = durations(m)
    idx = np.arange(len(d))
    if d.dtype == np.float64:
        nan = np.isnan(d)
        keep = idx[~nan]
        return [int(i) for i in keep[d[~nan].argsort(kind="quicksort")]] + \
            [int(i) for i in idx[nan]]
    return [int(i) for i in d.argsort(kind="quicksort")]
