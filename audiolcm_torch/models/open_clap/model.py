"""The LAION CLAP model: audio and text towers, the joint projections and the
per-modality logit scales (`audiolcm_tpu/models/open_clap/model.py`).

Reference `ldm/modules/encoders/open_clap/model.py:422-799`: the audio
branch (HTSAT or PANN), the text branch (roberta, bert, bart or the CLIP
transformer), `text_projection` / `audio_projection` (Linear, act, Linear
into joint_embed_shape 512), the `MLPLayers` transforms, logit scales
initialised to log(1/0.07), `encode_text`, the L2-normalised
`get_text_embedding` / `get_audio_embedding` and the 6-tuple forward.
Reference keys (`text_projection.{0,2}`, `text_transform.sequential.{0,3}`,
`logit_scale_a`, ...). Inference only: the transforms' dropout is left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from audiolcm_torch.models.clap_text import BertConfig, BertEncoder
from audiolcm_torch.models.open_clap.htsat import HTSAT, HTSATConfig
from audiolcm_torch.models.open_clap.pann import PannAudioBranch, PannConfig
from audiolcm_torch.models.open_clap.text_towers import (BartConfig, BartEncoder,
                                                         ClipTextTransformer, RobertaConfig,
                                                         RobertaEncoder, clip_eot_features)

# text branch -> (tower, its published config's class)
_TEXT_TOWERS = {"roberta": (RobertaEncoder, RobertaConfig), "bert": (BertEncoder, BertConfig),
                "bart": (BartEncoder, BartConfig)}


@dataclasses.dataclass(frozen=True)
class OpenClapConfig:
    embed_dim: int = 768  # audio branch output dim
    audio: Any = None  # HTSATConfig | PannConfig | None (text only)
    text_model_type: str = "roberta"  # 'roberta' | 'bert' | 'bart' | 'transformer'
    text_width: int = 512  # transformer branch only
    text_layers: int = 12
    text_heads: int = 8
    text_vocab: int = 49408
    context_length: int = 77
    joint_embed_shape: int = 512
    mlp_act: str = "relu"
    quick_gelu: bool = False
    # the roberta / bert / bart tower's config; None: the published preset
    # (roberta-base, bert-base-uncased, facebook/bart-base), as the reference
    # and the JAX package always build. A smaller one builds scaled-down towers.
    text_config: Any = None


class MLPLayers(nn.Module):
    """model.py:27-45: Linear, ReLU, (dropout), Linear."""

    def __init__(self, units=(512, 512, 512)):
        super().__init__()
        layers = []
        for a, b in zip(units[:-1], units[1:]):
            layers += [nn.Linear(a, b), nn.ReLU(), nn.Identity()]
        self.sequential = nn.Sequential(*layers[:-2])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sequential(x)


def _projection(d_in: int, d_out: int, act: str) -> nn.Sequential:
    """Linear -> act -> Linear into the joint space (model.py:487-491)."""
    return nn.Sequential(nn.Linear(d_in, d_out), nn.ReLU() if act == "relu" else nn.GELU(),
                         nn.Linear(d_out, d_out))


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


class OpenClap(nn.Module):
    def __init__(self, config: OpenClapConfig = OpenClapConfig()):
        super().__init__()
        cfg = self.config = config
        if isinstance(cfg.audio, HTSATConfig):
            self.audio_branch = HTSAT(cfg.audio)
        elif isinstance(cfg.audio, PannConfig):
            self.audio_branch = PannAudioBranch(cfg.audio)
        elif cfg.audio is not None:
            raise ValueError(f"unknown audio config {type(cfg.audio)}")
        else:
            self.audio_branch = None
        kind = cfg.text_model_type
        if kind == "transformer":
            self.text_branch = ClipTextTransformer(
                cfg.text_width, cfg.text_layers, cfg.text_heads, cfg.text_vocab,
                cfg.context_length, cfg.quick_gelu)
            text_out = cfg.text_width
        elif kind in _TEXT_TOWERS:
            tower, preset = _TEXT_TOWERS[kind]
            tcfg = cfg.text_config or preset()
            self.text_branch = tower(tcfg)
            text_out = tcfg.d_model if kind == "bart" else tcfg.hidden_size
        else:
            raise ValueError(f"Model type {kind} not found")
        j = cfg.joint_embed_shape
        self.text_projection = _projection(text_out, j, cfg.mlp_act)
        self.audio_projection = _projection(cfg.embed_dim, j, cfg.mlp_act)
        self.text_transform = MLPLayers((j, j, j))
        self.audio_transform = MLPLayers((j, j, j))
        self.logit_scale_a = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.logit_scale_t = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_text(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                    project: bool = True) -> torch.Tensor:
        """model.py:602-648: the pooled text feature projected into the joint
        space; project=False returns the per-token hidden states (the LAION
        embedder's per-token path projects those itself)."""
        kind = self.config.text_model_type
        if kind == "transformer":  # causal tower: the mask is not used
            feats = self.text_branch(input_ids)
            return self.text_projection(clip_eot_features(feats, input_ids)) if project else feats
        if kind == "roberta":
            hidden, pooled = self.text_branch(input_ids, attention_mask)
        elif kind == "bart":  # the UNMASKED mean (model.py:637-643)
            hidden = self.text_branch(input_ids, attention_mask)
            pooled = hidden.mean(dim=1)
        else:  # bert: the JAX package's BertEncoder has no pooler; CLS stands in
            hidden = self.text_branch(input_ids, attention_mask)
            pooled = hidden[:, 0]
        return self.text_projection(pooled) if project else hidden

    def encode_audio(self, waveform: Optional[torch.Tensor] = None,
                     mel_fusion: Optional[torch.Tensor] = None,
                     longer: Optional[torch.Tensor] = None) -> dict:
        return self.audio_branch(waveform=waveform, mel_fusion=mel_fusion, longer=longer)

    def get_text_embedding(self, input_ids: torch.Tensor,
                           attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _unit(self.encode_text(input_ids, attention_mask))

    def get_audio_embedding(self, waveform=None, mel_fusion=None, longer=None) -> torch.Tensor:
        return _unit(self.audio_projection(
            self.encode_audio(waveform, mel_fusion, longer)["embedding"]))

    def project_token_features(self, hidden: torch.Tensor) -> torch.Tensor:
        """text_projection per token (modules.py:287: the LAION embedder's
        per-token path)."""
        return self.text_projection(hidden)

    def forward(self, waveform=None, mel_fusion=None, longer=None, input_ids=None,
                attention_mask=None):
        """model.py:650-693: (audio, text, audio_transform(audio),
        text_transform(text), exp(logit_scale_a), exp(logit_scale_t))."""
        a = self.get_audio_embedding(waveform, mel_fusion, longer)
        t = self.get_text_embedding(input_ids, attention_mask)
        return (a, t, self.audio_transform(a), self.text_transform(t),
                self.logit_scale_a.exp(), self.logit_scale_t.exp())
