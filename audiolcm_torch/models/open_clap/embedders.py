"""The LAION CLAP text conditioners of the config registry
(`audiolcm_tpu/models/open_clap/embedders.py`).

Reference `ldm/modules/encoders/modules.py:242-341`: FrozenLAIONCLAPEmbedder
builds an HTSAT-tiny / roberta CLAP with enable_fusion and aff_2d, drops
the audio branch, and encodes text per token (`text_projection` of the
last hidden state, (B, 77, 512)) or, with `sentence`, as one L2-normalised
vector (B, 1, 512); FrozenLAIONCLAPSetenceEmbedder (the reference's
spelling) is the sentence form at max_length 512.

Tokenization runs on the host: `transformers.RobertaTokenizer` from a local
directory (`tokenizer_path`), imported at the first `encode`; the
`transformer` branch uses the package's CLIP BPE tokenizer and no mask.
The modules run on `device` (cuda:0 unless told otherwise).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from audiolcm_torch.models.open_clap.factory import create_model
from audiolcm_torch.models.open_clap.tokenizer import tokenize


class RobertaTokenizerHook:
    """The roberta tokenizer of a local directory: captions -> (ids, mask),
    each (B, max_length), padded to max_length."""

    def __init__(self, tokenizer_path: str, max_length: int):
        from transformers import RobertaTokenizer

        self.tokenizer = RobertaTokenizer.from_pretrained(tokenizer_path)
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]):
        batch = self.tokenizer(list(texts), truncation=True, max_length=self.max_length,
                               padding="max_length", return_tensors="pt")
        return batch["input_ids"], batch["attention_mask"]


class FrozenLAIONCLAPEmbedder(nn.Module):
    """modules.py:242-289. encode(texts) -> (B, max_length, 512) projected
    per-token features, or (B, 1, 512) with `sentence`."""

    def __init__(self, weights_path: str = "", sentence: bool = False, max_length: int = 77,
                 tokenizer_path: str = "roberta-base", amodel: str = "HTSAT-tiny",
                 tmodel: str = "roberta", device=None):
        from audiolcm_torch.pipeline import resolve_device

        super().__init__()
        self.sentence, self.max_length = sentence, max_length
        self.tokenizer_path = tokenizer_path
        self._tokenizer = None
        model, _ = create_model(amodel, tmodel, weights_path, enable_fusion=True,
                                fusion_type="aff_2d")
        # the audio side is deleted, as in the reference (modules.py:259)
        model.audio_branch = model.audio_transform = model.audio_projection = None
        self.model = model.to(resolve_device(device)).eval().requires_grad_(False)

    @property
    def tokenizer(self):
        """captions -> (ids, mask); assign another callable to replace it."""
        if self._tokenizer is None:
            self._tokenizer = RobertaTokenizerHook(self.tokenizer_path, self.max_length)
        return self._tokenizer

    @tokenizer.setter
    def tokenizer(self, fn) -> None:
        self._tokenizer = fn

    @torch.no_grad()
    def encode_ids(self, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = self.model.logit_scale_t.device
        input_ids = torch.as_tensor(input_ids, device=device).long()
        attention_mask = (torch.ones_like(input_ids) if attention_mask is None
                          else torch.as_tensor(attention_mask, device=device))
        if self.sentence:
            return self.model.get_text_embedding(input_ids, attention_mask)[:, None]
        return self.model.project_token_features(
            self.model.encode_text(input_ids, attention_mask, project=False))

    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        if self.model.config.text_model_type == "transformer":
            return self.encode_ids(tokenize(list(texts), self.max_length))
        return self.encode_ids(*self.tokenizer(texts))


class FrozenLAIONCLAPSetenceEmbedder(FrozenLAIONCLAPEmbedder):
    """modules.py:291-341 (the reference's spelling): always the sentence
    embedding, tokenized at max_length 512."""

    def __init__(self, weights_path: str = "", tokenizer_path: str = "roberta-base", **kw):
        super().__init__(weights_path, sentence=True, max_length=512,
                         tokenizer_path=tokenizer_path, **kw)
