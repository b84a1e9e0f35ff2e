"""The one traffic generator: a mix file and a seed -> a request sequence.

A mix (`benchmark/traffic/<name>.json`) gives the batch, the mel lengths
of its duration classes with their weights in whole numbers, the token
length and the loop. Requests come in blocks that hold every class as often
as its weight says, each block in an order drawn from the seed: every seed
sends the same mix of sizes, in another order. Token ids are uniform over
each tower's vocabulary, drawn per request from the seed on the host (int64,
what the port's tokenizers return); each request also carries the seed of
its own device generator, from which the program draws x_T and its noise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Iterator, List

import torch

HOP, SAMPLE_RATE = 256, 16000  # BigVGAN's upsampling and the 16 kHz output


def derive(seed: int, *parts) -> int:
    """A 63-bit seed from the run's seed and a path of names or numbers."""
    h = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


@dataclasses.dataclass
class Request:
    index: int
    batch: int
    mel_len: int
    clap_ids: torch.Tensor
    t5_ids: torch.Tensor
    draw_seed: int

    @property
    def latent_len(self) -> int:
        return self.mel_len // 2

    @property
    def audio_s(self) -> float:
        """Seconds of audio the request delivers, all clips together."""
        return self.batch * self.mel_len * HOP / SAMPLE_RATE


def class_order(traffic: dict, seed: int, index: int) -> int:
    """The mel length of request `index`."""
    block: List[int] = [m for m, w in zip(traffic["mel_lens"], traffic["mix"]) for _ in range(w)]
    random.Random(derive(seed, "block", index // len(block))).shuffle(block)
    return block[index % len(block)]


def request(traffic: dict, config: dict, seed: int, index: int) -> Request:
    b, tok = traffic["batch"], traffic["tokens"]
    ids = [torch.randint(0, config[tower]["vocab_size"], (b, tok),
                         generator=torch.Generator().manual_seed(derive(seed, tower, index)))
           for tower in ("clap_text", "t5")]
    return Request(index=index, batch=b, mel_len=class_order(traffic, seed, index),
                   clap_ids=ids[0], t5_ids=ids[1], draw_seed=derive(seed, "draws", index))


def requests(traffic: dict, config: dict, seed: int, start: int = 0) -> Iterator[Request]:
    index = start
    while True:
        yield request(traffic, config, seed, index)
        index += 1
