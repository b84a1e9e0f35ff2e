"""The LAION CLAP's text towers: RoBERTa, the CLIP text transformer and the
BART encoder (`audiolcm_tpu/models/open_clap/text_towers.py`).

- RoBERTa (and the `bert` branch's BERT, `models/clap_text.BertEncoder`): the
  HF encoder and the pooler that `CLAP.encode_text` reads
  (`open_clap/model.py:617-635`). The layers are `models/clap_text.BertLayer`
  with RoBERTa's deltas: position ids cumsum(ids != pad) * (ids != pad) +
  pad (padding_idx 1), vocab 50265, LayerNorm eps 1e-5, one token type.
  HF RobertaModel keys.
- The CLIP text tower of the `transformer` branch: token and learned
  position embeddings, pre-LN residual blocks under a causal mask
  (`model.py:259-303,581-587`), ln_final; the caller takes the features at
  the EOT token (`clip_eot_features`). Its keys follow the reference's
  Transformer (`resblocks.<i>.attn.in_proj_weight`, ...), but its
  embeddings live in this module; no checkpoint conversion exists for it.
- BART (facebook/bart-base's encoder, the `bart` branch): positions at
  arange(L) + 2, layernorm_embedding, post-LN blocks with erf GELU. HF
  BartModel's `encoder.*` keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiolcm_torch.models.clap_text import BertConfig, _Embeddings, _Layers
from audiolcm_torch.nn.attention import dot_product_attention, padding_bias


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5

    def bert(self) -> BertConfig:
        return BertConfig(vocab_size=self.vocab_size, hidden_size=self.hidden_size,
                          num_layers=self.num_layers, num_heads=self.num_heads,
                          intermediate_size=self.intermediate_size,
                          max_position_embeddings=self.max_position_embeddings,
                          type_vocab_size=1, layer_norm_eps=self.layer_norm_eps)


class _Pooler(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense = nn.Linear(d, d)


class RobertaEncoder(nn.Module):
    """input_ids (B, L) [+ attention_mask] -> (last_hidden_state (B, L, d),
    pooler_output (B, d))."""

    def __init__(self, config: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config.bert())
        self.encoder = _Layers(config.bert(), fuse_proj=False)
        self.pooler = _Pooler(config.hidden_size)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        cfg, e = self.config, self.embeddings
        not_pad = (input_ids != cfg.pad_token_id).long()
        position_ids = torch.cumsum(not_pad, dim=1) * not_pad + cfg.pad_token_id
        h = e.LayerNorm(e.word_embeddings(input_ids) + e.position_embeddings(position_ids)
                        + e.token_type_embeddings.weight[0])
        mask_bias = padding_bias(attention_mask)
        for layer in self.encoder.layer:
            h = layer(h, mask_bias)
        return h, torch.tanh(self.pooler.dense(h[:, 0]))


class _ClipAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(width, width)


class _ClipMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class _ClipBlock(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _ClipAttention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _ClipMlp(width)


class ClipTextTransformer(nn.Module):
    """text ids (B, L <= context_length) -> per-token features after ln_final
    (B, L, width)."""

    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8,
                 vocab_size: int = 49408, context_length: int = 77, quick_gelu: bool = False):
        super().__init__()
        self.width, self.heads, self.context_length = width, heads, context_length
        self.quick_gelu = quick_gelu
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        nn.init.normal_(self.positional_embedding, std=0.01)
        self.resblocks = nn.ModuleList([_ClipBlock(width) for _ in range(layers)])
        self.ln_final = nn.LayerNorm(width, eps=1e-5)

    def forward(self, text_ids: torch.Tensor) -> torch.Tensor:
        b, t = text_ids.shape
        if t > self.context_length:
            raise ValueError(
                f"sequence length {t} exceeds the CLIP text tower's context_length "
                f"{self.context_length}; the 512-token sentence embedder requires the roberta "
                "branch")
        x = self.token_embedding(text_ids) + self.positional_embedding[None, :t]
        causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        hd = self.width // self.heads
        split = lambda a: a.reshape(b, t, self.heads, hd).transpose(1, 2)
        for blk in self.resblocks:
            y = blk.ln_1(x)
            q, k, v = F.linear(y, blk.attn.in_proj_weight, blk.attn.in_proj_bias).chunk(3, dim=-1)
            attn = dot_product_attention(split(q), split(k), split(v), hd**-0.5, causal)
            x = x + blk.attn.out_proj(attn.transpose(1, 2).reshape(b, t, self.width))
            y = blk.mlp.c_fc(blk.ln_2(x))
            y = y * torch.sigmoid(1.702 * y) if self.quick_gelu else F.gelu(y)
            x = x + blk.mlp.c_proj(y)
        return self.ln_final(x)


def clip_eot_features(features: torch.Tensor, text_ids: torch.Tensor) -> torch.Tensor:
    """The features at the EOT token, the largest id of each row
    (model.py:615)."""
    return features[torch.arange(features.shape[0], device=features.device),
                    text_ids.argmax(dim=-1)]


@dataclasses.dataclass(frozen=True)
class BartConfig:
    """facebook/bart-base encoder constants (the reference's `bart` branch
    loads exactly this preset, `open_clap/model.py:515-524`)."""

    vocab_size: int = 50265
    d_model: int = 768
    num_layers: int = 6
    num_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 1024
    pad_token_id: int = 1
    pos_offset: int = 2  # HF BartLearnedPositionalEmbedding offset
    layer_norm_eps: float = 1e-5


class _BartAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _BartLayer(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = _BartAttention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)


class _BartStack(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + cfg.pos_offset,
                                            cfg.d_model)
        self.layernorm_embedding = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([_BartLayer(cfg) for _ in range(cfg.num_layers)])


class BartEncoder(nn.Module):
    """input_ids (B, L) [+ attention_mask] -> encoder_last_hidden_state
    (B, L, d_model); the reference's bart branch consumes its unmasked mean
    (`model.py:637-643`)."""

    def __init__(self, config: BartConfig = BartConfig()):
        super().__init__()
        self.config = config
        self.encoder = _BartStack(config)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, enc = self.config, self.encoder
        b, t = input_ids.shape
        pos = enc.embed_positions.weight[cfg.pos_offset:cfg.pos_offset + t]
        h = enc.layernorm_embedding(enc.embed_tokens(input_ids) + pos[None])
        mask_bias = padding_bias(attention_mask)
        hd = cfg.d_model // cfg.num_heads
        split = lambda a: a.reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        for layer in enc.layers:  # self-attention, then the POST layer norm
            sa = layer.self_attn
            q = sa.q_proj(h) * hd**-0.5
            attn = dot_product_attention(split(q), split(sa.k_proj(h)), split(sa.v_proj(h)), 1.0,
                                         mask_bias)
            h = layer.self_attn_layer_norm(h + sa.out_proj(attn.transpose(1, 2).reshape(b, t, -1)))
            h = layer.final_layer_norm(h + layer.fc2(F.gelu(layer.fc1(h))))
        return h
