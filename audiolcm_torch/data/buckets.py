"""The duration-bucket lattice of mel lengths (`audiolcm_tpu/data/buckets.py`).

The reference pads each batch to its longest mel rounded up to a multiple
of 4, clamped to [64, 1248] (`joinaudiodataset_anylen.py:210-267`):
`reference_pad_length`. The JAX package quantises batch lengths to a fixed
lattice so each length compiles once; the port keeps the same lattice and
`bucket_for_length` so both packages batch the same clips to the same
lengths. 312/624 are the 5 s/10 s lengths, 640 holds the 625-frame 10 s
clips of the anylen datasets, 1248 is 20 s. Pad value -5, the log-mel floor.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Sequence

DEFAULT_MEL_BUCKETS: tuple = (64, 128, 192, 256, 312, 384, 448, 512, 624, 640, 752, 880, 1000,
                              1248)

PAD_VALUE = -5.0
MIN_LEN = 64
MAX_LEN = 1248
MIN_FACTOR = 4


def bucket_for_length(n: int, lattice: Sequence[int] = DEFAULT_MEL_BUCKETS) -> int:
    """Smallest bucket >= n (clamped to the largest bucket)."""
    n = max(MIN_LEN, min(n, lattice[-1]))
    i = bisect_left(lattice, n)
    return lattice[min(i, len(lattice) - 1)]


def reference_pad_length(lengths: Sequence[int]) -> int:
    """The reference's per-batch pad length: the longest length clamped to
    [64, 1248] and rounded up to a multiple of 4."""
    size = max(MIN_LEN, min(max(lengths), MAX_LEN))
    if size % MIN_FACTOR:
        size += MIN_FACTOR - size % MIN_FACTOR
    return size
