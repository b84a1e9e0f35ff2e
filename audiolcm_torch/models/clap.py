"""The whole CLAP contrastive model: text and audio towers and the
temperature (`audiolcm_tpu/models/clap.py`).

Reference `ldm/modules/encoders/CLAP/clap.py:54-88`
(`wav_evaluation/models/clap.py`): the BERT tower's CLS vector and the
Cnn14 embedding, each projected into the shared 1024-d space and
L2-normalised, and a learned logit scale (temperature 0.003 -> init
log(1 / 0.003)); the symmetric InfoNCE objective. The CLAP score uses the
CLS vector, where generation (`models/clap_text.ClapTextEncoder`) projects
the whole sequence. State dicts keep the reference keys:
`caption_encoder.{base,projection}.*`, `audio_encoder.{base,projection}.*`
and `logit_scale`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.clap_audio import ClapAudioConfig, ClapAudioEncoder
from audiolcm_torch.models.clap_text import BertConfig, ClapTextEncoder


class CLAP(nn.Module):
    def __init__(self, text_config: BertConfig = BertConfig(),
                 audio_config: ClapAudioConfig = ClapAudioConfig(), d_proj: int = 1024,
                 temperature: float = 0.003):
        super().__init__()
        self.caption_encoder = ClapTextEncoder(text_config, d_proj)
        self.audio_encoder = ClapAudioEncoder(audio_config, d_proj)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / temperature)))

    def embed_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> the projected CLS vector (B, d_proj), not normalised."""
        enc = self.caption_encoder
        return enc.projection(enc.base(input_ids)[:, 0, :])

    def forward(self, input_ids: torch.Tensor, wav: torch.Tensor):
        """(B, L) token ids + (B, S) 44.1 kHz wav -> (text_emb, audio_emb,
        logit_scale), the embeddings L2-normalised."""
        text = F.normalize(self.embed_text(input_ids), dim=-1, eps=0.0)
        audio = F.normalize(self.audio_encoder(wav), dim=-1, eps=0.0)
        return text, audio, torch.exp(self.logit_scale)


def clap_contrastive_loss(text_emb: torch.Tensor, audio_emb: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the in-batch similarity matrix."""
    logits = logit_scale * text_emb @ audio_emb.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
