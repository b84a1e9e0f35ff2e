"""CLIP BPE tokenizer for the open_clap 'transformer' text branch
(`audiolcm_tpu/models/open_clap/tokenizer.py`).

On the host, in plain Python. The reference's vendored OpenAI tokenizer
(`ldm/modules/encoders/open_clap/tokenizer.py:68-180`): byte-level BPE over
this package's copy of `bpe_simple_vocab_16e6.txt.gz` (the first 48,894
merges), vocab = 256 byte units + 256 word-final units + merges + the two
specials `<start_of_text>`/`<end_of_text>` = 49,408 ids, lowercased input,
CLIP's regex pre-split, a zero-padded / truncated (B, context_length) int64
tensor out. The split pattern needs the `regex` module: without it the
tokenizer raises ImportError. The reference runs `ftfy.fix_text` before
cleaning; ftfy is optional here (without it, identity: it only repairs
mojibake).
"""

from __future__ import annotations

import gzip
import html
import os
from typing import Dict, List, Sequence, Tuple, Union

import torch

try:  # pattern needs \p{L}/\p{N}; the `regex` module provides them
    import regex as _re
except ImportError:
    _re = None

try:
    import ftfy as _ftfy
except ImportError:  # optional: only mojibake repair
    _ftfy = None

_VOCAB_GZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bpe_simple_vocab_16e6.txt.gz")
_N_MERGES = 49152 - 256 - 2  # tokenizer.py:73 slice bound

SOT = "<start_of_text>"
EOT = "<end_of_text>"

_SPLIT_PATTERN = (r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"""
                  r"""[^\s\p{L}\p{N}]+""")


def byte_unicode_table() -> Dict[int, str]:
    """GPT-2 style reversible byte -> printable-unicode map (tokenizer.py:22-41
    semantics): printable latin bytes map to themselves, the rest to a
    private range starting at U+0100."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


def _clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


class ClipBpeTokenizer:
    """Loads once; `encode` per string, `tokenize` for padded batches."""

    def __init__(self, vocab_path: str = _VOCAB_GZ,
                 special_tokens: Sequence[str] = (SOT, EOT)):
        if _re is None:
            raise ImportError("the CLIP tokenizer needs the `regex` module")
        self._b2u = byte_unicode_table()
        self._u2b = {u: b for b, u in self._b2u.items()}

        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges: List[Tuple[str, str]] = []
        for line in lines[1:1 + _N_MERGES]:  # line 0 is the header
            a, b = line.split()
            merges.append((a, b))
        self.merge_rank: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}

        units = list(byte_unicode_table().values())
        vocab = units + [u + "</w>" for u in units]
        vocab += ["".join(m) for m in merges]
        vocab += list(special_tokens)
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.vocab_size = len(self.encoder)
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache: Dict[str, str] = {t: t for t in special_tokens}
        self._pat = _re.compile(
            "|".join(special_tokens) + "|" + _SPLIT_PATTERN, _re.IGNORECASE)

    # -- BPE core ----------------------------------------------------------

    def _merge_word(self, token: str) -> str:
        """Apply merges (lowest-rank first) until no ranked pair remains."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self.merge_rank.get((a, b), None), i)
                      for i, (a, b) in enumerate(zip(parts, parts[1:]))]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, i = min(ranked)
            best = (parts[i], parts[i + 1])
            # merge EVERY adjacent occurrence of the chosen pair this round
            out: List[str] = []
            j = 0
            while j < len(parts):
                if (j < len(parts) - 1
                        and (parts[j], parts[j + 1]) == best):
                    out.append(parts[j] + parts[j + 1])
                    j += 2
                else:
                    out.append(parts[j])
                    j += 1
            parts = out
        joined = " ".join(parts)
        self._cache[token] = joined
        return joined

    # -- public API ---------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _re.findall(self._pat, _clean(text).lower()):
            mapped = "".join(self._b2u[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[u] for u in self._merge_word(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        joined = "".join(self.decoder[i] for i in ids)
        raw = bytes(self._u2b[u] for u in joined)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


_default: ClipBpeTokenizer | None = None


def tokenize(texts: Union[str, List[str]], context_length: int = 77) -> torch.Tensor:
    """(B, context_length) int64, `<sot> ids <eot>` zero-padded / truncated,
    as the reference's `tokenizer.py:152-180`; the ids feed
    `ClipTextTransformer`."""
    global _default
    if _default is None:
        _default = ClipBpeTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    out = torch.zeros((len(texts), context_length), dtype=torch.long)
    for row, text in enumerate(texts):
        ids = [_default.sot_id] + _default.encode(text) + [_default.eot_id]
        ids = ids[:context_length]
        out[row, : len(ids)] = torch.tensor(ids)
    return out
